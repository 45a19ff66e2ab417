"""Tracing and metrics (``libre_tpu.utils.profiling``).

Per-stage wall timers, the rays/s counter (the BASELINE metric) and a
device trace around a region.  ``StageTimers`` and ``RaysPerSecond`` are
host clocks, as in the reference: a caller timing work on the card
synchronises before the region ends (no synchronise is hidden here).
``device_trace`` is ``torch.profiler`` with CPU and CUDA activities,
written as a Chrome trace; ``annotate`` is a ``record_function`` range,
plus an NVTX range when CUDA is present.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


class StageTimers:
    """Named accumulating wall-clock timers (select / upload / render /
    composite stages of the frame loop)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name}: {t * 1e3:.2f} ms total / {n} = "
                         f"{t / n * 1e3:.2f} ms avg")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


class RaysPerSecond:
    """The BASELINE throughput counter: rays rendered / wall time."""

    def __init__(self):
        self.rays = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_rays: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.rays += n_rays

    @property
    def mrays_per_s(self) -> float:
        return self.rays / self.seconds / 1e6 if self.seconds else 0.0


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` trace (CPU, and CUDA when present) around a
    region, written to ``log_dir``/``TRACE_FILE`` as a Chrome trace;
    yields the profiler (its ``key_averages()`` read the region), or
    None and traces nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range for host-side stages inside a ``device_trace``: a
    ``record_function`` range, and an NVTX range when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
