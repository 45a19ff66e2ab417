"""The ``fit.dense256`` cell on the CPU at a tiny size: its entries and
files found by name, a sound run correct and its traced run reading the
cell's per-layer metrics, each fault failing, ``calibrate.py``'s calls
reaching the driver as that file stands, and a program without the
classification counter and the dense spans (a checkout that predates
them) running the cell with those metrics left out."""

import json
from pathlib import Path

import pytest
import torch

from conftest import _merge, make_tiny_root, run_cpu
from perfbench import check

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "fit.dense256"
METRICS = {"render_roofline.dense", "tf_gather_ms.dense", "classify_calls.dense",
           "launches.dense", "device_idle.dense"}
# 16³, 32 planes, 16² views and slope grids.
TINY = ({"volume": {"n": 16}, "renderer": {"samples_per_ray": 32}, "viewport": [16, 16],
         "slope_grid": [16, 16]}, {"job_steps": 4})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_tiny_root(tmp_path_factory.mktemp("tiny_dense"))
    cfg = json.loads((ROOT / "perfbench" / "configs" / "dense256.json").read_text())
    (root / "perfbench" / "configs" / "dense256.json").write_text(
        json.dumps(_merge(cfg, TINY[0])))
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "fit_dense_pre.json").read_text())
    (root / "perfbench" / "traffic" / "fit_dense_pre.json").write_text(
        json.dumps(_merge(traffic, TINY[1])))
    return root


def test_the_cell_and_its_files():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("dense256", "fit_dense_pre", 1)
    entry = next(c for c in BENCH["configs"] if c["name"] == "dense256")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    exact = json.loads((ROOT / "perfbench" / "configs" / "exact512.json").read_text())
    assert cfg["orbit"] == exact["orbit"] and cfg["tf_entries"] == exact["tf_entries"]
    assert cfg["volume"] == {**exact["volume"], "n": 256}
    assert cfg["renderer"] == {**exact["renderer"], "classification": "pre"}
    # A deployment of its own: the raw datasource's, not the renderer's.
    assert cfg["source"] == entry["source"] != exact["source"]
    assert entry["source"].endswith("RawDataSource.cpp#L78-L88")
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["viewport"] == cfg["slope_grid"] == [256, 256]
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "fit_dense_pre.json").read_text())
    assert traffic == {"driver": "dense_fit", "views": 4, "view_stride": 2, "lr": 0.03,
                       "checked_steps": 3, "job_steps": 100}
    assert (ROOT / "perfbench" / "drivers" / f"{traffic['driver']}.py").is_file()
    listed = {m["name"] for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])}
    assert listed == METRICS
    assert all(m["workloads"] == [CELL] for m in BENCH["per_layer"] if m["name"] in METRICS)
    moved = {m["name"] for m in BENCH["end_to_end"] if CELL in m.get("workloads", [CELL])}
    assert moved == {"train_mrays_per_s", "setup_s"}
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{CELL}.json").read_text())["limits"]
    assert set(limits) == {"loss_gap", "grad_gap", "leaf_grad_gap", "step_gap"}


def test_sound_run_is_correct_and_traced(root):
    out = run_cpu(root, CELL)
    assert out["correct"] is True, out["compared"]
    assert set(out["metrics"]) == {"train_mrays_per_s", "setup_s"}
    traced = run_cpu(root, CELL, trace=1, seconds=0.3)
    # The roofline reads the card's busy time: on the CPU there is none.
    assert set(traced["metrics"]) == METRICS - {"render_roofline.dense"}
    assert traced["metrics"]["classify_calls.dense"]["value"] == 4.0  # one a view
    assert traced["metrics"]["tf_gather_ms.dense"]["value"] == 0.0


def test_state_unchanged_fails(root, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    out = run_cpu(root, CELL)
    assert out["correct"] is False
    assert out["compared"]["step_gap"]["value"] > out["compared"]["step_gap"]["limit"]


def test_half_batch_fails(root, monkeypatch):
    from libre_tpu_torch.train.shearwarp_trainer import ShearWarpProblem

    real = ShearWarpProblem.render_views

    def half(self, mesh, volume, tf):  # the trained views only, not the targets
        imgs = real(self, mesh, volume, tf)
        return imgs[: len(imgs) // 2] if torch.is_grad_enabled() else imgs

    monkeypatch.setattr(ShearWarpProblem, "render_views", half)
    assert run_cpu(root, CELL)["correct"] is False


def test_altered_answer_fails(root, monkeypatch):
    from libre_tpu_torch.ops import shearwarp as sw

    real = sw.render_slope_grid

    def altered(*args):  # a trained render 1% off, not the targets'
        img, ug, vg = real(*args)
        return (img * 1.01 if torch.is_grad_enabled() else img), ug, vg

    monkeypatch.setattr(sw, "render_slope_grid", altered)
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


def test_a_program_without_the_counter_and_spans_leaves_them_out(root, monkeypatch):
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import transfer_function as tfm
    from libre_tpu_torch.train import shearwarp_trainer
    from libre_tpu_torch.utils.profiling import NO_SPAN

    def classify(volume_zyx, tf, data_source_range):  # the body before the counter
        lo, hi = data_source_range
        density = torch.clamp((volume_zyx.to(torch.float32) - lo) / (hi - lo), 0.0, 1.0)
        rgba = tfm.lookup(tf, density)
        return tuple(rgba[..., i] for i in range(4))

    monkeypatch.setattr(sw, "precompute_classified_volume", classify)
    for module in (sw, tfm, shearwarp_trainer):
        monkeypatch.setattr(module, "span", lambda name: NO_SPAN)
    assert run_cpu(root, CELL)["correct"] is True
    traced = run_cpu(root, CELL, trace=1, seconds=0.3)
    assert set(traced["metrics"]) == {"launches.dense", "device_idle.dense"}
