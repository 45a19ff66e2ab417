"""The device trace of a ``--trace 1`` run, reduced to what the per-layer
metrics read.

``torch.profiler`` (CPU and CUDA activities, CUPTI) records the window;
its Chrome trace is read once.  The window is the host range
``perfbench.window`` the harness opens around the measured loop.  Device
time is the union of the kernels', copies' and memsets' intervals inside
it (intervals that overlap count once); a kernel's time is the sum of its
launches' durations; the time of a host range (``Optimizer.step#…``) is
the device time of the launches made inside it, matched by the CUPTI
correlation id."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW_RANGE = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


class Trace:
    """The window's device work, from one Chrome trace's events
    (timestamps in µs, reported in seconds)."""

    def __init__(self, events: List[Dict]):
        win = [e for e in events if e.get("name") == WINDOW_RANGE and e.get("ph") == "X"
               and e.get("cat") in HOST_CATS]
        if not win:
            raise ValueError(f"the trace holds no {WINDOW_RANGE} range")
        w = win[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.device = []  # (ts, end, name, cat, correlation)
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b <= self.t0 or a >= self.t1:
                continue
            self.device.append((max(a, self.t0), min(b, self.t1), e.get("name", ""),
                                e["cat"], (e.get("args") or {}).get("correlation")))
        self.busy = _merge([(a, b) for a, b, *_ in self.device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        tid = w.get("tid")
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid
            and e.get("name") != WINDOW_RANGE
        )
        self.launches = sorted(
            (float(e["ts"]), (e.get("args") or {}).get("correlation"))
            for e in events if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
        )

    def kernel(self, part: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds ``part``."""
        spans = [b - a for a, b, name, cat, _c in self.device if cat == "kernel" and part in name]
        return sum(spans) * 1e-6, len(spans)

    def ranges(self, prefix: str) -> Tuple[float, int]:
        """(device seconds, count) of the host ranges named ``prefix…``:
        the device time of the work launched inside them."""
        spans = [(a, b) for a, b, name in self.host if name.startswith(prefix)]
        ts = [t for t, _c in self.launches]
        corr = set()
        for a, b in spans:
            for i in range(bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)):
                corr.add(self.launches[i][1])
        corr.discard(None)
        busy = [(a, b) for a, b, _n, _cat, c in self.device if c in corr]
        return sum(b - a for a, b in _merge(busy)) * 1e-6, len(spans)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for a, b, name, _cat, _c in self.device:
            total[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time inside the window, summed by the
        innermost host range open where each gap starts."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        starts = [a for a, _b, _n in self.host]
        total: Dict[str, float] = defaultdict(float)
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            name = "no host range"
            # Ranges on one thread nest: the latest-starting one that is
            # still open at the gap's start is the innermost.
            last = bisect.bisect_right(starts, a) - 1
            for j in range(last, max(last - 5000, -1), -1):
                if self.host[j][1] >= a:
                    name = self.host[j][2]
                    break
            total[name] += (b - a) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


class Profiler:
    """``torch.profiler`` around the window when ``enabled``; ``trace``
    holds the :class:`Trace` after it closes (the Chrome trace goes to a
    temporary file under ``TMPDIR`` and is deleted once read)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Optional[Trace] = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.trace = Trace(events)
        return False
