"""What the benchmark scripts share: logging, timing that waits for the
device, the render kernels' launch counts, and the checks that hold one
call of each kernel a script runs against its plain version on the same
inputs.  (Their cameras are ``apps.render_cli.build_camera``'s and their
smooth volume is ``testing.smooth_volume``; ``bench.py``, which has the
reference's copies, imports jax.)"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from typing import Callable, Dict, Tuple

import torch

from ..testing import compare, compare_grads

# kernel -> the largest max |kernel − plain| of this process's checks
MAX_ABS_ERR: Dict[str, float] = {}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device, iters: int = 10) -> Tuple[float, object]:
    """(seconds per call, the last output) of ``fn()`` after one warm-up
    call: on a CUDA device by CUDA events around ``iters`` calls, ended by
    a synchronise; on the CPU by the host clock."""
    out = fn()
    synchronize(device)
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) / iters, out


def launch_counts() -> dict:
    """The render kernels' launch counts in this process, by kernel
    (each wrapper adds one where it launches its kernel)."""
    from ..ops import exact, shearwarp_bricked, shearwarp_dense, shearwarp_grad

    return {
        "post_sweep": shearwarp_bricked.post_sweep.launches,
        "store_grid_bwd": shearwarp_grad.store_grid_backward.launches,
        "exact_march": exact.march_exact.launches,
        "exact_march_bwd": exact.march_exact_backward.launches,
        "pre_sweep": shearwarp_dense.pre_sweep.launches,
    }


def _plain_versions() -> dict:
    """kernel -> (module, wrapper name, the plain version called as the
    wrapper is)."""
    from ..ops import exact
    from ..ops import shearwarp_bricked as swb
    from ..ops import shearwarp_grad as swg

    def march_exact_plain(*args, width=None, **kwargs):
        return exact.march_exact_reference(*args, **kwargs)

    return {
        "post_sweep": (swb, "post_sweep", swb.post_sweep_reference),
        "store_grid_bwd": (swg, "store_grid_backward", swg.store_grid_backward_reference),
        "exact_march": (exact, "march_exact", march_exact_plain),
        "exact_march_bwd": (exact, "march_exact_backward", exact.march_exact_backward_reference),
    }


@contextlib.contextmanager
def plain(*kernels: str):
    """A check's run: inside, the named kernels' wrappers run their plain
    versions on any device (the same call sites, on the same operands),
    and no launch made inside counts: every launch count is as it was on
    entry when the block ends."""
    table = _plain_versions()
    wrappers = {k: getattr(module, name) for k, (module, name, _) in table.items()}
    counts = {k: w.launches for k, w in wrappers.items()}
    try:
        for k in kernels:
            module, name, plain_fn = table[k]
            setattr(module, name, plain_fn)
        yield
    finally:
        for k, (module, name, _) in table.items():
            setattr(module, name, wrappers[k])
            wrappers[k].launches = counts[k]


def check(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str, tol) -> None:
    """``testing.compare`` of ``kernel``'s output with its plain
    version's within ``tol`` = (max, mean); raises past it."""
    compare(got, want, what, tol)
    _record(kernel, got, want)


def check_grads(kernel: str, got, want, what: str, early_exit: float) -> None:
    """``testing.compare_grads`` of each gradient of ``got`` with
    ``want``'s (normalised by the plain one's max |·|, the backward
    kernels' tolerances at ``early_exit``); raises past them."""
    for i, (a, b) in enumerate(zip(got, want)):
        compare_grads(a, b, f"{what}, gradient {i}", early_exit)
        _record(kernel, a, b)


def _record(kernel, got, want):
    err = float((got - want).abs().max())
    MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0.0), err)


def print_launches() -> None:
    """Two lines, last on standard output: ``max_abs_err {json}`` (by
    kernel, over this process's checks) and ``launches {json}`` of
    :func:`launch_counts`."""
    print("max_abs_err " + json.dumps(MAX_ABS_ERR), flush=True)
    print("launches " + json.dumps(launch_counts()), flush=True)
