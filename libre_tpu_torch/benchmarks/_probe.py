"""What the probe modules share: the probe record, seeded inputs, the
check against the plain version and the timing on the card."""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..ops import _kernels, gather


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


def launch_floor_ms(reps: int = 200) -> float:
    """Device milliseconds per launch of an empty kernel
    (``csrc/launch_floor.cu``) timed as the probes are (``graph_ms``): the
    floor a probe's time is read against."""
    return graph_ms(lambda: _kernels.launch("launch_floor"), reps)


def against_parent(probes: Sequence[Probe], parent: Path, kernels: Sequence[str],
                   device="cuda", seed: int = 0, reps: int = 200,
                   rounds: int = 2) -> Dict[str, Dict[str, List[float]]]:
    """Each probe of ``probes`` whose kernel is one of ``kernels``, timed
    as this checkout builds it and as ``parent`` (another checkout, e.g.
    a parent commit unpacked with ``git archive``) does: both sources
    built with the port's flags and ``-Xptxas -v``, the parent's bound
    with the launcher its own source declares and launched on the
    operands this checkout's wrapper passes (recorded from one call),
    its output held bit-equal to this checkout's; then both timed in a
    CUDA graph (``graph_ms``), in ``rounds`` rounds of this, parent,
    parent, this.  Prints both builds' registers and returns {probe id:
    {"this" / "parent": [ms of each run]}}."""
    device = require_card(device)
    out_dir = Path(tempfile.mkdtemp(prefix="probe_ab-"))
    try:
        jobs = {}
        for name in kernels:
            jobs[name] = _kernels.SRC_DIR / f"{name}.cu"
            jobs[f"{name} parent"] = parent / "libre_tpu_torch" / "csrc" / f"{name}.cu"
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {t: pool.submit(_kernels.build_verbose, out_dir, t, src)
                       for t, src in jobs.items()}
            built = {t: f.result() for t, f in futures.items()}
        parents = {}
        for tag, (lib, report) in built.items():
            print(f"  build {tag}: {_kernels.report_text(report)}")
        for name in kernels:
            fn = getattr(ctypes.CDLL(str(built[f"{name} parent"][0])), name)
            fn.argtypes = _kernels.declared_signature(jobs[f"{name} parent"], name)
            fn.restype = ctypes.c_int
            parents[name] = fn
        times = {}
        for p in probes:
            fn, args, _work = p.build(device=device, seed=seed)
            name = kernel_name(fn)
            if name not in parents:
                continue
            recorded = []
            real = _kernels.launch
            _kernels.launch = lambda n, *a: (recorded.append(a), real(n, *a))[1]
            try:
                got = fn(*args)
            finally:
                _kernels.launch = real
            (operands,) = recorded
            out_at = next(i for i, a in enumerate(operands) if a is not None
                          and isinstance(a, torch.Tensor) and a.data_ptr() == got.data_ptr())
            out = torch.empty_like(got)
            cargs = [out.data_ptr() if i == out_at else
                     a.data_ptr() if isinstance(a, torch.Tensor) else a
                     for i, a in enumerate(operands)]

            def parent_call(f=parents[name], cargs=cargs):
                err = f(*cargs, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name} parent launch failed: cudaError_t {err}")

            parent_call()
            torch.cuda.synchronize(device)
            if not torch.equal(out, got):
                raise AssertionError(f"{p.id}: the parent's {name} differs from this build's")
            runs = {"this": lambda: fn(*args), "parent": parent_call}
            ms = {k: [] for k in runs}
            for _ in range(rounds):
                for k in ("this", "parent", "parent", "this"):
                    ms[k].append(graph_ms(runs[k], reps))
            times[p.id] = ms
        return times
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def against_parent_lines(times: Dict[str, Dict[str, List[float]]], floor_ms: float) -> List[str]:
    """One line per probe of ``against_parent``'s times, in µs: each
    build's least and most run, this build's least against the parent's,
    the spread (the wider of the two builds' most − least) and the launch
    floor."""
    lines = []
    for pid, ms in times.items():
        this, parent = min(ms["this"]), min(ms["parent"])
        spread = max(max(v) - min(v) for v in ms.values())
        lines.append(f"    {pid}: this {this * 1e3:.3f}-{max(ms['this']) * 1e3:.3f}; parent "
                     f"{parent * 1e3:.3f}-{max(ms['parent']) * 1e3:.3f} (this "
                     f"{this / parent - 1:+.1%}); spread {spread * 1e3:.3f}; launch floor "
                     f"{floor_ms * 1e3:.3f}")
    return lines
