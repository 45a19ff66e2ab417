"""The check that decides ``correct``, at a tiny size on the CPU: a sound
run passes; a run with the timed path broken underneath fails, once for
each fault its cell can have; the precision control (the reference in
bfloat16 in the program's place) fails the committed limits.

The faults: a step that leaves the state unchanged (the optimizer's step
does nothing), half of the batch left out with the mean over the rest
(half the views or rays), an answer altered where it is produced (a
trained render 1% off, or one pixel of a frame 0.05 off)."""

import pytest
import torch

from conftest import run_cpu
from perfbench import check

FIT_CELLS = ["fit.store512", "fit_density.store512", "fit.exact512"]


@pytest.mark.parametrize("cell", FIT_CELLS + ["view.exact512"])
def test_sound_run_is_correct(tiny_root, cell):
    out = run_cpu(tiny_root, cell)
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_state_unchanged_fails(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run_cpu(tiny_root, cell)
    assert out["correct"] is False
    assert out["compared"]["step_gap"]["value"] > out["compared"]["step_gap"]["limit"]


def _halve_store_batch(monkeypatch):
    from libre_tpu_torch.train import store_trainer

    real = store_trainer.make_loss_fn

    def half(problem, mesh=None):
        import dataclasses

        keep = len(problem.views) // 2
        loss = real(dataclasses.replace(problem, views=problem.views[:keep]), mesh)
        return lambda store, tf, targets: loss(store, tf, targets[:keep])

    monkeypatch.setattr(store_trainer, "make_loss_fn", half)


def _halve_exact_batch(monkeypatch):
    from libre_tpu_torch.train import trainer

    real = trainer.render_exact_diff

    def half(volume, tf, view):
        out = real(volume, tf, view)
        return out[: out.shape[0] // 2]

    monkeypatch.setattr(trainer, "render_exact_diff", half)
    real_mse = trainer._mse
    monkeypatch.setattr(trainer, "_mse", lambda out, target: real_mse(out, target[: out.shape[0]]))


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_half_batch_fails(tiny_root, cell, monkeypatch):
    (_halve_exact_batch if "exact" in cell else _halve_store_batch)(monkeypatch)
    assert run_cpu(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", FIT_CELLS + ["view.exact512"])
def test_altered_answer_fails(tiny_root, cell, monkeypatch):
    if "store" in cell:
        from libre_tpu_torch.ops import shearwarp_grad as swg
        from libre_tpu_torch.train import store_trainer

        real = swg.render_store_grid_diff

        def altered_view(*a):  # the trained render, not the targets'
            out = real(*a)
            return out * 1.01 if torch.is_grad_enabled() else out

        monkeypatch.setattr(store_trainer.swg, "render_store_grid_diff", altered_view)
    else:
        from libre_tpu_torch.ops import exact

        real = exact.RenderMarcherDiff.apply

        def altered(volume, tf, view):  # a trained render, or one pixel of a frame
            out = real(volume, tf, view)
            if cell.startswith("fit"):
                return out * 1.01 if torch.is_grad_enabled() else out
            return out + torch.where(torch.arange(out.shape[0])[:, None] == 7, 0.05, 0.0)

        monkeypatch.setattr(exact.RenderMarcherDiff, "apply", altered)
    assert run_cpu(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", FIT_CELLS + ["view.exact512"])
def test_control_and_faults_fail_the_limits(tiny_root, cell, capsys):
    """``calibrate.py`` at a tiny size: the sound readings within every
    limit; the bfloat16 control and each fault beyond one of them."""
    from perfbench import calibrate

    summary = calibrate.main(["--workload", cell, "--seeds", "2", "--faults", "2"], tiny_root)
    limits = check.load_limits(tiny_root, cell)
    assert check.verdict(summary["sound_max"], limits), summary
    kinds = {k for v in summary["least"].values() for k in v}
    assert "control" in kinds and "half_batch" in kinds
    for kind in kinds:
        assert any(v[kind] > limits[name] for name, v in summary["least"].items()), (kind, summary)
