"""What the probe modules share: the probe record, seeded inputs, the
check against the plain version and the timing on the card."""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import gather


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: ``build(device, seed)`` gives ``(fn, args, work)``, where
    ``fn`` is a ``functools.partial`` of a wrapper of ``ops/gather.py``
    and ``work`` counts the values it gathers; ``replaces`` is the
    reference's ``pallas_call`` (file:line); ``library`` is the one
    PyTorch call of the same function on ``args`` with int64 indices,
    where there is one."""

    id: str
    label: str
    build: Callable
    replaces: str
    library: Optional[Callable] = None
    library_name: str = "none: no one call"


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def indices(low: int, high: int, shape, g: torch.Generator, device) -> torch.Tensor:
    """int32 indices, uniform in [low, high)."""
    return torch.randint(low, high, shape, generator=g, device=device, dtype=torch.int32)


def kernel_name(fn: functools.partial) -> str:
    return next(name for name, w in gather.KERNELS.items() if w is fn.func)


def plain_of(fn: functools.partial) -> functools.partial:
    """The plain PyTorch version of a probe's ``fn``, with its arguments."""
    return functools.partial(fn.func.reference, *fn.args, **fn.keywords)


def require_card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the probes time CUDA kernels: no CUDA device for {device}")
    return device


def call_ms(fn: Callable, budget_ms: float = 40.0) -> float:
    """Milliseconds per call of ``fn`` called back to back from Python,
    by CUDA events (so the host's share of each call counts where it is
    the longer), over as many calls as fit ``budget_ms`` (3 to 200)
    after one warm-up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(200, max(3, budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed once warm and once timed by CUDA events, so
    no host time enters.  (Capturing runs the wrappers, which count one
    launch each; the replays launch without counting.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def timed(fn: Callable, budget_ms: float = 40.0):
    """(device ms per call in a CUDA graph, ms per call from Python)."""
    eager = call_ms(fn, budget_ms)
    return graph_ms(fn, int(min(200, max(3, budget_ms / max(eager, 1e-3))))), eager


def run(probes: Sequence[Probe], device="cuda", seed: int = 0) -> List[Dict]:
    """Run each probe on the card: its kernel once against its plain
    version (and its library call) on the same inputs, raising unless
    they are bit-equal, then the three timed on the device (``timed``:
    in a CUDA graph, and the kernel and library call also back to back
    from Python).  Prints one line per probe and returns one record
    each; times in ms."""
    device = require_card(device)
    print("device:", torch.cuda.get_device_name(device))
    results = []
    for p in probes:
        fn, args, work = p.build(device=device, seed=seed)
        plain = plain_of(fn)
        lib_args = tuple(a.long() if a.dtype == torch.int32 else a for a in args)
        launches = fn.func.launches
        got, want = fn(*args), plain(*args)
        lib = p.library(*lib_args) if p.library is not None else None
        torch.cuda.synchronize(device)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{p.id} {p.label}: kernel differs from plain (max|d| {err})")
        if lib is not None and not torch.equal(lib, want):
            raise AssertionError(f"{p.id} {p.label}: {p.library_name} differs from plain")
        ms, ms_call = timed(lambda: fn(*args))
        plain_ms, _ = timed(lambda: plain(*args))
        library_ms = library_call = None
        if p.library is not None:
            library_ms, library_call = timed(lambda: p.library(*lib_args))
        launches = fn.func.launches - launches
        lib_text = (f"{p.library_name} {library_ms * 1e3:.2f} us ({library_call * 1e3:.2f} "
                    f"us from Python)" if library_ms is not None else p.library_name)
        print(f"[OK]   {p.id} {p.label}: {ms * 1e3:.2f} us -> {work / ms / 1e6:.2f} G gathers/s "
              f"({ms_call * 1e3:.2f} us from Python); plain {plain_ms * 1e3:.2f} us; library "
              f"{lib_text}; bit-equal to plain ({got.numel()} values); {launches} launches of "
              f"{kernel_name(fn)}")
        results.append(dict(
            probe=p.id, label=p.label, kernel=kernel_name(fn), replaces=p.replaces,
            work=work, ms=ms, ms_call=ms_call, plain_ms=plain_ms, library=p.library_name,
            library_ms=library_ms, library_call_ms=library_call, max_abs_err=err,
            launches=launches,
        ))
    return results
