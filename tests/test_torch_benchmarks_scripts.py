"""The port's throughput and demo scripts (``libre_tpu_torch/benchmarks``:
``bench_forward``, ``probe_bwd_breakdown``, ``demo_inverse_render``,
``demo_out_of_core``) through their ``main(argv)`` at a tiny size on the
CPU, where they run the plain versions: each runs to its end, prints its
rows, its checks' errors (each kernel it runs checked once) and its
launch line (no kernel launched on the CPU), the demos' losses fall, and ``demo_out_of_core`` at 64³ (its finest level, 512
bricks of 8³ over a 1 MB budget) writes into ``tmp_path`` a
JSON record with the JAX script's keys."""

import json
import os

import pytest
import torch

from libre_tpu_torch.benchmarks import (
    SCRIPTS,
    _common,
    bench_forward,
    demo_inverse_render,
    demo_out_of_core,
    probe_bwd_breakdown,
)
from libre_tpu_torch.benchmarks._common import check, check_grads, plain
from libre_tpu_torch.ops import exact

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_LAUNCHES = {"post_sweep": 0, "store_grid_bwd": 0, "exact_march": 0, "exact_march_bwd": 0,
               "pre_sweep": 0}


def _launches(out, checked=()):
    """The launch counts of the last line; the line before holds the
    checks' errors, one for each kernel of ``checked`` at least."""
    err_line, line = out.strip().splitlines()[-2:]
    assert err_line.startswith("max_abs_err ") and line.startswith("launches ")
    errors = json.loads(err_line[len("max_abs_err "):])
    assert set(checked) <= set(errors)
    assert all(v < 1e-5 for v in errors.values())  # on the CPU both sides run plain code
    return json.loads(line[len("launches "):])


def test_scripts_listed():
    assert SCRIPTS == ("bench_forward", "probe_bwd_breakdown", "demo_inverse_render",
                       "demo_out_of_core")


def test_bench_forward(capsys):
    rows = bench_forward.main(["--device", "cpu", "--vox", "8", "--img", "8", "--spr", "16",
                               "--iters", "1"])
    assert [(r["which"], r["mode"]) for r in rows] == [
        ("fast", "fwd"), ("oracle", "fwd"), ("fast", "fwd"), ("fast", "fwd"), ("fast", "fwd"),
        ("fast", "bwd")]
    assert all(r["ms"] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "oracle fwd vol=8^3" in out and "Mrays/s" in out
    assert _launches(out, ("exact_march", "exact_march_bwd")) == NO_LAUNCHES
    quick = bench_forward.main(["--quick", "--device", "cpu", "--vox", "8", "--img", "8",
                                "--spr", "16", "--iters", "1"])
    assert len(quick) == 3


def test_probe_bwd_breakdown(capsys):
    result = probe_bwd_breakdown.main(["--device", "cpu", "--img", "8", "--vox", "8",
                                       "--planes", "8", "--iters", "1"])
    assert set(result) == {"forward_ms", "fwd_bwd_no_tf_ms", "fwd_bwd_tf_ms", "plain_k2_ms"}
    captured = capsys.readouterr()
    assert "fwd+bwd diff_tf=True" in captured.err and "oracle: plain K2" in captured.err
    assert _launches(captured.out, ("post_sweep", "store_grid_bwd")) == NO_LAUNCHES


def test_demo_inverse_render(capsys):
    store = demo_inverse_render.main(["--device", "cpu", "--vox", "12", "--img", "12",
                                      "--planes", "12", "--steps", "8", "--views", "2"])
    assert store["last"] < store["first"]
    assert "loss" in capsys.readouterr().out
    ex = demo_inverse_render.main(["--device", "cpu", "--vox", "12", "--img", "10",
                                   "--planes", "16", "--steps", "8", "--views", "2",
                                   "--exact"])
    assert ex["last"] < ex["first"] and ex["density_err"] > 0
    out = capsys.readouterr().out
    assert "exact inverse render" in out
    assert _launches(out, ("post_sweep", "store_grid_bwd", "exact_march",
                           "exact_march_bwd")) == NO_LAUNCHES


def test_demo_out_of_core_record(tmp_path, capsys):
    out = tmp_path / "ooc.json"
    demo_out_of_core.main([
        "--device", "cpu", "--vox", "64", "--img", "16", "--frames", "2", "--planes", "16",
        "--block", "8", "--min-lod", "3", "--store", str(tmp_path / "v.lod"), "--out",
        str(out), "--incore-mb", "64", "--ooc-mb", "1",
    ])
    record = json.loads(out.read_text())
    source = open(os.path.join(ROOT, "benchmarks", "demo_out_of_core.py")).read()
    keys, run_keys = demo_out_of_core.RECORD_KEYS, demo_out_of_core.RUN_KEYS
    assert all(f'"{k}"' in source for k in keys + run_keys)  # the JAX script's keys
    assert set(record) == set(keys)
    for name in ("incore", "out_of_core"):
        assert set(record[name]) == set(run_keys)
    assert record["out_of_core"]["atlas_evictions"] > 0
    assert record["out_of_core"]["passes_per_frame"] > 1
    captured = capsys.readouterr()
    assert "every out-of-core frame bit-equal to its in-core frame" in captured.err
    assert _launches(captured.out, ("post_sweep",)) == NO_LAUNCHES


def test_plain_swaps_the_wrappers_and_keeps_the_counts():
    """``_common.plain``: inside, the named wrappers are their plain
    versions; after, the wrappers are back with their counts as on entry."""
    wrapper, bwd = exact.march_exact, exact.march_exact_backward
    before = wrapper.launches
    with plain("exact_march"):
        assert exact.march_exact is not wrapper
        assert exact.march_exact_backward is bwd
        wrapper.launches += 1  # a launch made inside
    assert exact.march_exact is wrapper and wrapper.launches == before


def test_check_raises_past_the_bound():
    _common.MAX_ABS_ERR.pop("pre_sweep", None)
    x = torch.zeros(4, 4)
    check("pre_sweep", x, x + 1e-6, "within", (1e-5, 1e-5))
    assert _common.MAX_ABS_ERR["pre_sweep"] == pytest.approx(1e-6)
    with pytest.raises(AssertionError, match="disagrees"):
        check("pre_sweep", x, x + 1e-2, "past the max", (2e-3, 1e-5))
    with pytest.raises(AssertionError, match="disagrees"):
        check_grads("pre_sweep", [x + 1.0], [x + 1.1], "past the gradient bound", 1.1)
    _common.MAX_ABS_ERR.pop("pre_sweep")
