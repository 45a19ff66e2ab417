"""The ``fit.exactset512`` cell on the CPU at a tiny size: its entries and
files found by name, a sound run correct and its traced run reading the
cell's per-layer metrics, each fault failing, ``calibrate.py``'s calls
reaching the driver as that file stands, and a program without the
bricking failing at once (a checkout that predates the cell)."""

import json
from pathlib import Path

import pytest
import torch

from conftest import _merge, make_tiny_root, run_cpu
from perfbench import check

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "fit.exactset512"
METRICS = {"k3_roofline.set", "k4_roofline.set", "shard_rays_ms.set", "host_idle_ms.set",
           "device_idle.set", "host_reads.set"}
# 32³ in 4³ bricks of 8³ (12³ with the ghost voxels), 16² rays.
TINY = ({"volume": {"n": 32}, "bricking": {"block_size": 8}, "renderer": {"samples_per_ray": 32}},
        {"viewport": [16, 16], "job_steps": 4, "reference_block": 100})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("tiny_set"))
    cfg = json.loads((ROOT / "perfbench" / "configs" / "exactset512.json").read_text())
    (root / "perfbench" / "configs" / "exactset512.json").write_text(
        json.dumps(_merge(cfg, TINY[0])))
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "fit_exact_set.json").read_text())
    (root / "perfbench" / "traffic" / "fit_exact_set.json").write_text(
        json.dumps(_merge(traffic, TINY[1])))
    return root


def test_the_cell_and_its_files():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("exactset512", "fit_exact_set", 1)
    entry = next(c for c in BENCH["configs"] if c["name"] == "exactset512")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    one = json.loads((ROOT / "perfbench" / "configs" / "exact512.json").read_text())
    for key in ("volume", "renderer", "tf_entries", "orbit"):
        assert cfg[key] == one[key], key
    # A deployment of its own: the bricking's source, not the renderer's.
    assert cfg["source"] == entry["source"] != one["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert (cfg["bricking"]["block_size"], cfg["bricking"]["overlap"]) == (64, 2)
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "fit_exact_set.json").read_text())
    fit = json.loads((ROOT / "perfbench" / "traffic" / "fit_exact.json").read_text())
    for key in ("viewport", "early_exit", "lr", "checked_steps", "job_steps"):
        assert traffic[key] == fit[key], key
    assert traffic["views"] == cfg["orbit"]["poses"]
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    listed = {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert listed == METRICS
    moved = {m["name"] for m in BENCH["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert moved == {"train_mrays_per_s", "setup_s"}
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{CELL}.json").read_text())["limits"]
    assert set(limits) == {"loss_gap", "grad_gap", "leaf_grad_gap", "step_gap"}


def test_sound_run_is_correct_and_traced(root):
    out = run_cpu(root, CELL)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"train_mrays_per_s", "setup_s"}
    traced = run_cpu(root, CELL, trace=1, seconds=0.3)
    # The rooflines read the card's kernels: on the CPU there are none.
    assert set(traced["metrics"]) == METRICS - {"k3_roofline.set", "k4_roofline.set"}
    assert traced["metrics"]["host_reads.set"]["value"] == 5.0
    assert traced["metrics"]["shard_rays_ms.set"]["value"] > 0.0


def test_state_unchanged_fails(root, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run_cpu(root, CELL)
    assert out["correct"] is False
    assert out["compared"]["step_gap"]["value"] > out["compared"]["step_gap"]["limit"]


def test_half_batch_fails(root, monkeypatch):
    from libre_tpu_torch.train import trainer

    real = trainer._mse
    monkeypatch.setattr(trainer, "_mse", lambda out, target: real(out[: out.shape[0] // 2],
                                                                  target[: out.shape[0] // 2]))
    assert run_cpu(root, CELL)["correct"] is False


def test_altered_answer_fails(root, monkeypatch):
    from libre_tpu_torch.parallel import render

    real = render.join_rgba

    def altered(seg):  # a trained render 1% off, not the targets'
        out = real(seg)
        return out * 1.01 if torch.is_grad_enabled() else out

    monkeypatch.setattr(render, "join_rgba", altered)
    assert run_cpu(root, CELL)["correct"] is False


def test_calibrate_reaches_the_driver(root):
    """``calibrate.py`` as it stands: the sound readings within every
    limit; the bfloat16 control and the half batch (``reference(keep=
    views // 2)``) each beyond one of them."""
    from perfbench import calibrate

    summary = calibrate.main(["--workload", CELL, "--seeds", "2", "--faults", "1"], root)
    limits = check.load_limits(root, CELL)
    assert check.verdict(summary["sound_max"], limits), summary
    kinds = {k for v in summary["least"].values() for k in v}
    assert kinds == {"control", "half_batch"}
    for kind in kinds:
        assert any(v[kind] > limits[name] for name, v in summary["least"].items()), (kind, summary)


def test_a_program_without_the_bricking_fails_at_once(root, monkeypatch):
    from libre_tpu_torch.data import lod_store

    monkeypatch.delattr(lod_store, "brick_volume")
    with pytest.raises(ImportError):
        run_cpu(root, CELL)
