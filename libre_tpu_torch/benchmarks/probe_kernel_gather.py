"""The in-kernel TF lookup probes of ``benchmarks/probe_kernel_gather.py``
(P11-P13) on the card: nearest and two-tap linear RGBA lookups of a
256-entry table by density, at the sweep's shapes (512 planes of 64×256),
on the port's hand-written kernels, the table in L1 (nearest) or in
shared memory (linear).  P13's
table, padded to 512 entries on the TPU, is looked up unpadded.  No one
PyTorch call computes them.  Unlike the reference module, nothing runs
at import.

    python -m libre_tpu_torch.benchmarks.probe_kernel_gather
"""

from __future__ import annotations

import functools

import torch

from ..ops import gather
from ._probe import Probe, generator, run

V, U, T, K = 64, 256, 256, 512
V3, U3 = 64, 512


def f1(device="cuda", seed=0):
    """P11: ``t[clip(int(d·T), 0, T − 1)]``, d (K, V, U), t (T,)."""
    g = generator(device, seed)
    d = torch.rand((K, V, U), generator=g, device=device)
    t = torch.rand((T,), generator=g, device=device)
    fn = functools.partial(gather.tf_nearest, scale=float(T), outside="clip")
    return fn, (d, t), K * V * U


def f2(device="cuda", seed=0):
    """P12: the two-tap linear lookup of a (4, T) RGBA table,
    d (K, V, U) → (K, 4, V, U); 8 gathered values per density."""
    g = generator(device, seed)
    d = torch.rand((K, V, U), generator=g, device=device)
    t = torch.rand((4, T), generator=g, device=device)
    return functools.partial(gather.tf_linear), (d, t), K * V * U * 8


def f3(device="cuda", seed=0):
    """P13: P11's lookup on d (V3, U3)."""
    g = generator(device, seed)
    d = torch.rand((V3, U3), generator=g, device=device)
    t = torch.rand((T,), generator=g, device=device)
    fn = functools.partial(gather.tf_nearest, scale=float(T), outside="clip")
    return fn, (d, t), V3 * U3


PROBES = (
    Probe("P11", "axis1 gather 512 planes (64,256)", f1, "benchmarks/probe_kernel_gather.py:41"),
    Probe("P12", "rgba 2-tap lookup 512 planes", f2, "benchmarks/probe_kernel_gather.py:83"),
    Probe("P13", "padded-table U=512", f3, "benchmarks/probe_kernel_gather.py:119"),
)


def main(device="cuda"):
    return run(PROBES, device)


if __name__ == "__main__":
    main()
