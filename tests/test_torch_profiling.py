"""The port's ``utils/profiling`` against the JAX package's: the same
``StageTimers.report()`` text for the same totals, the ``RaysPerSecond``
arithmetic, ``device_trace`` on the CPU writing a Chrome trace (and doing
nothing for None), and nested ``annotate`` ranges in that trace."""

import json
import os

import pytest
import torch

from libre_tpu.utils import profiling as prof_j
from libre_tpu_torch.utils import profiling as prof_t

TOTALS = {"select": (0.0123456, 3), "upload": (1.5, 2), "render": (0.25, 7), "a": (1e-6, 1)}


def _filled(module):
    timers = module.StageTimers()
    for name, (seconds, count) in TOTALS.items():
        timers.totals[name] = seconds
        timers.counts[name] = count
    return timers


def test_stage_timers_report_matches_jax():
    got, want = _filled(prof_t).report(), _filled(prof_j).report()
    assert got == want
    assert got.splitlines()[0] == "a: 0.00 ms total / 1 = 0.00 ms avg"
    timers = prof_t.StageTimers()
    for _ in range(2):
        with timers.stage("x"):
            pass
    assert timers.counts["x"] == 2 and timers.totals["x"] >= 0.0
    with pytest.raises(RuntimeError):
        with timers.stage("raises"):
            raise RuntimeError("the stage is timed all the same")
    assert timers.counts["raises"] == 1
    timers.reset()
    assert timers.report() == ""


def test_rays_per_second():
    counter = prof_t.RaysPerSecond()
    assert counter.mrays_per_s == 0.0
    counter.rays, counter.seconds = 3_000_000, 1.5
    assert counter.mrays_per_s == pytest.approx(2.0)
    with counter.measure(1_000_000):
        pass
    assert counter.rays == 4_000_000 and counter.seconds >= 1.5
    ref = prof_j.RaysPerSecond()
    ref.rays, ref.seconds = 3_000_000, 1.5
    assert ref.mrays_per_s == pytest.approx(2.0)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with prof_t.device_trace(None) as nothing:
        assert nothing is None
    log_dir = str(tmp_path / "trace")
    with prof_t.device_trace(log_dir) as prof:
        with prof_t.annotate("outer"):
            with prof_t.annotate("inner"):
                torch.ones(64).cumsum(0)
    path = os.path.join(log_dir, prof_t.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner"} <= names
