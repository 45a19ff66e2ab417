"""Gather probes of ``benchmarks/probe_gather.py`` (P1-P4) on the card.

The reference probed which gathers Mosaic lowers inside a Pallas kernel
on the TPU; here each is the port's hand-written kernel for the same
lookup.  P4 did P3's lookup as a one-hot matrix product on the TPU's
matrix unit; on the card it is P3's gather.  The reference's XLA probes
are not kernels: each probe here prints its PyTorch call's time instead.

    python -m libre_tpu_torch.benchmarks.probe_gather
"""

from __future__ import annotations

import functools

import torch

from ..ops import gather
from ._probe import Probe, generator, indices, run

R = 1024  # rays per tile (8, 128)
N = 64 * 64 * 64  # flat brick size


def build_take_flat(device="cuda", seed=0):
    """P1: ``out = d.reshape(-1)[i]``, d (2048, 128), i (8, 128) in [0, N)."""
    g = generator(device, seed)
    d = torch.randn((N // 128, 128), generator=g, device=device)
    i = indices(0, N, (8, 128), g, device)
    return functools.partial(gather.take), (d, i), R


def build_take_along_lane(device="cuda", seed=0):
    """P2: ``out[r, l] = d[r, i[r, l]]`` on (8, 128)."""
    g = generator(device, seed)
    d = torch.randn((8, 128), generator=g, device=device)
    i = indices(0, 128, (8, 128), g, device)
    return functools.partial(gather.take_along, axis=1), (d, i), R


def build_take_along_sublane(device="cuda", seed=0):
    """P3: ``out[r, l] = d[i[r, l], l]``, d (512, 128), i (8, 128) in [0, 512)."""
    g = generator(device, seed)
    d = torch.randn((512, 128), generator=g, device=device)
    i = indices(0, 512, (8, 128), g, device)
    return functools.partial(gather.take_along, axis=0), (d, i), R


def build_onehot_mxu(device="cuda", seed=0):
    """P4: P3's lookup, which the TPU computed as a one-hot (8, 128, 512)
    einsum; here the gather itself."""
    return build_take_along_sublane(device, seed)


PROBES = (
    Probe("P1", "pallas take flat (2d idx from N)", build_take_flat,
          "benchmarks/probe_gather.py:53", lambda d, i: torch.take(d, i), "torch.take"),
    Probe("P2", "pallas take_along_axis lane", build_take_along_lane,
          "benchmarks/probe_gather.py:71", lambda d, i: torch.gather(d, 1, i), "torch.gather"),
    Probe("P3", "pallas take_along_axis sublane", build_take_along_sublane,
          "benchmarks/probe_gather.py:90", lambda d, i: torch.gather(d, 0, i), "torch.gather"),
    Probe("P4", "pallas onehot mxu 512", build_onehot_mxu,
          "benchmarks/probe_gather.py:115", lambda d, i: torch.gather(d, 0, i), "torch.gather"),
)


def main(device="cuda"):
    return run(PROBES, device)


if __name__ == "__main__":
    main()
