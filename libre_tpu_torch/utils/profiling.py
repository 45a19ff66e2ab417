"""Tracing (``libre_tpu.utils.profiling``): one span primitive, a device
trace around a region, and per-stage wall timers.

:func:`span` names a stretch of the program's host work.  While a
``torch.profiler`` records, it is a ``record_function`` range: it lands
in the same trace, on the same clock, as the device's kernels, copies and
memsets, on whatever thread opened it.  Otherwise it is one shared no-op
context after a single flag check.  The program's spans are named
``libre.<layer>.<stage>``.  ``device_trace`` is ``torch.profiler`` with
CPU and CUDA activities, written as a Chrome trace.  ``StageTimers`` is a
host clock, as in the reference: a caller timing work on the card
synchronises before the region ends (no synchronise is hidden here).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a
    ``torch.profiler`` records; otherwise :data:`NO_SPAN`, the shared
    no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)
