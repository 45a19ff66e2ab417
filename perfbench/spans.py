"""The program's spans in a ``--trace 1`` run, and what the per-layer
metrics read from them.

The program names its host work with ``libre.<layer>.<stage>`` ranges
(``libre_tpu_torch.utils.profiling.span``), recorded by the window's
``torch.profiler`` on whatever thread opened them: a trainer's backward
runs K2's and K4's host side on autograd's device thread, so the spans
are read from every thread, not only the window's.  Only spans wholly
inside the window count.  The spans come from the profiler's Kineto
events (the Chrome trace can be saved once, and the harness has saved
it); they are put on the Chrome trace's clock by the window range, which
both hold.

A span's device idle time is the part of the window's idle intervals it
covers: each idle interval is cut where a span opens or closes, and each
piece is put down to the latest-opened span still open at its start, on
any thread; where none is, to ``no program span`` and the innermost
range open on the window's thread (the cell's loss read, its
synchronise).  A span's launches are the kernels, copies and memsets
whose runtime call, matched by CUPTI correlation, was made while it was
open, on any thread."""

from __future__ import annotations

import bisect
import gc
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench.trace import HOST_CATS, WINDOW_RANGE

PREFIX = "libre."
NO_SPAN = "no program span"


class Spans:
    """The ``libre.*`` spans of Chrome trace ``events`` that lie wholly in
    ``trace``'s window (a :class:`perfbench.trace.Trace`), against that
    trace's device intervals and launches."""

    def __init__(self, events: List[Dict], trace):
        self.trace = trace
        rows = []
        for e in events:
            name = e.get("name", "")
            if e.get("ph") != "X" or e.get("cat") not in HOST_CATS or not name.startswith(PREFIX):
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if trace.t0 <= a and b <= trace.t1:
                rows.append((a, b, name, e.get("tid")))
        self.rows = sorted(rows)
        self.starts = [a for a, *_ in self.rows]
        self.reach = []  # the latest end of the spans opened so far
        for _a, b, *_ in self.rows:
            self.reach.append(max(b, self.reach[-1]) if self.reach else b)
        self.host_starts = [a for a, _b, _n in trace.host]

    def named(self, name: str) -> List[Tuple[float, float]]:
        return [(a, b) for a, b, n, _t in self.rows if n == name]

    def mean_ms(self, name: str) -> Optional[float]:
        """The mean length of the spans ``name``, in ms; None without one."""
        spans = self.named(name)
        if not spans:
            return None
        return sum(b - a for a, b in spans) * 1e-3 / len(spans)

    def open_at(self, x: float) -> Optional[str]:
        """The latest-opened span still open at ``x``, on any thread."""
        j = bisect.bisect_right(self.starts, x) - 1
        while j >= 0 and self.reach[j] > x:
            a, b, name, _t = self.rows[j]
            if b > x:
                return name
            j -= 1
        return None

    def idle_split(self) -> Dict[str, float]:
        """The window's device idle seconds by the span they fall under
        (``NO_SPAN`` where none is open)."""
        t = self.trace
        edges = [t.t0] + [x for ab in t.busy for x in ab] + [t.t1]
        cuts = sorted({x for a, b, *_ in self.rows for x in (a, b)})
        out: Dict[str, float] = defaultdict(float)
        for i in range(0, len(edges), 2):
            a, b = edges[i], edges[i + 1]
            if b <= a:
                continue
            inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
            for lo, hi in zip([a] + inner, inner + [b]):
                name = self.open_at(lo) or f"{NO_SPAN} ({self._host_range_at(lo)})"
                out[name] += (hi - lo) * 1e-6
        return dict(out)

    def _host_range_at(self, x: float) -> str:
        """The innermost range other than a program span open at ``x`` on
        the window's thread."""
        host = self.trace.host
        last = bisect.bisect_right(self.host_starts, x) - 1
        for j in range(last, max(last - 5000, -1), -1):
            if host[j][1] > x and not host[j][2].startswith(PREFIX):
                return host[j][2]
        return "no host range"

    def idle_ms(self, per: str) -> Optional[float]:
        """Device idle ms under any program span, per span ``per``."""
        units = len(self.named(per))
        if not units:
            return None
        split = self.idle_split()
        total = sum(split.values())
        print("perfbench: device idle by program span (s, share of the idle time): "
              + "; ".join(f"{k} {v:.4f} {100.0 * v / max(total, 1e-12):.1f}%"
                          for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
              + f"; idle {total:.4f} of a {self.trace.window_s:.4f} s window", file=sys.stderr)
        return sum(v for k, v in split.items() if not k.startswith(NO_SPAN)) * 1e3 / units

    def launches(self, name: str) -> Optional[float]:
        """Kernels, copies and memsets per span ``name``, launched while
        one was open (on any thread)."""
        spans = self.named(name)
        if not spans:
            return None
        ts = [t for t, _c in self.trace.launches]
        corr = set()
        for a, b in spans:
            for i in range(bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)):
                corr.add(self.trace.launches[i][1])
        corr.discard(None)
        return sum(1 for *_x, c in self.trace.device if c in corr) / len(spans)


def _profiler_events(trace) -> List[Dict]:
    """The ``libre.*`` ranges of the ``torch.profiler`` that recorded
    ``trace`` (the harness's ``perfbench.trace.Profiler``), as Chrome
    trace events on its clock; empty where none is found.  Read from the
    profiler's raw Kineto events: building its ``events()`` list takes a
    minute for a store cell's window."""
    from torch.autograd import DeviceType

    prof = _recorder_of(trace)
    results = None if prof is None else getattr(prof.prof.profiler, "kineto_results", None)
    if results is None:
        return []
    cpu = [e for e in results.events() if e.device_type() == DeviceType.CPU]
    window = next((e for e in cpu if e.name() == WINDOW_RANGE), None)
    if window is None:
        return []
    t0_ns = window.start_ns()
    return [{"ph": "X", "cat": "user_annotation", "name": e.name(), "tid": e.start_thread_id(),
             "ts": trace.t0 + (e.start_ns() - t0_ns) * 1e-3, "dur": e.duration_ns() * 1e-3}
            for e in cpu if e.name().startswith(PREFIX)]


def _recorder_of(trace):
    """The ``perfbench.trace.Profiler`` whose ``trace`` is ``trace``,
    found among the objects that refer to it (the instance, or its
    attribute dict), or None."""
    from perfbench.trace import Profiler

    for ref in gc.get_referrers(trace):
        if isinstance(ref, dict):
            ref = next((o for o in gc.get_referrers(ref)
                        if isinstance(o, Profiler) and o.__dict__ is ref), None)
        if isinstance(ref, Profiler) and ref.trace is trace:
            return ref
    return None


_READ: Dict[int, Spans] = {}


def of(trace) -> Spans:
    """The program's spans of a run's trace, read once a trace."""
    if id(trace) not in _READ:
        t = time.perf_counter()
        _READ.clear()
        _READ[id(trace)] = Spans(_profiler_events(trace), trace)
        print(f"perfbench: {len(_READ[id(trace)].rows)} program spans in the window, read in "
              f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    return _READ[id(trace)]
