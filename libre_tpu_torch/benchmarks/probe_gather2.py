"""Gather probes of ``benchmarks/probe_gather2.py`` (P5-P9) on the card:
loop sums of LOOP shifted lane and sublane gathers, a full-shape sublane
gather and a row take, each on the port's hand-written kernels.  The
loop sums have no one PyTorch call; the reference's XLA probes are not
kernels and are not carried over.

    python -m libre_tpu_torch.benchmarks.probe_gather2
"""

from __future__ import annotations

import functools

import torch

from ..ops import gather
from ._probe import Probe, generator, indices, run

LOOP = 512


def build_lane_gather_loop(device="cuda", seed=0):
    """P5: ``out[r, l] = Σ_{k<LOOP} d[r, (i[r, l] + k) % 128]``, (8, 128)."""
    g = generator(device, seed)
    d = torch.randn((8, 128), generator=g, device=device)
    i = indices(0, 128, (8, 128), g, device)
    fn = functools.partial(gather.take_along, axis=1, loop=LOOP, mod=128)
    return fn, (d, i), LOOP * 8 * 128


def build_lane_gather_wide(device="cuda", seed=0):
    """P6: the same sum from a wide table: d (8, 1024), i (8, 128), mod 1024."""
    g = generator(device, seed)
    d = torch.randn((8, 1024), generator=g, device=device)
    i = indices(0, 1024, (8, 128), g, device)
    fn = functools.partial(gather.take_along, axis=1, loop=LOOP, mod=1024)
    return fn, (d, i), LOOP * 8 * 128


def build_sublane_gather_fullshape(device="cuda", seed=0):
    """P7: ``out[r, l] = d[i[r, l], l]`` on (512, 128)."""
    g = generator(device, seed)
    d = torch.randn((512, 128), generator=g, device=device)
    i = indices(0, 512, (512, 128), g, device)
    return functools.partial(gather.take_along, axis=0), (d, i), 512 * 128


def build_sublane_gather_8(device="cuda", seed=0):
    """P8: ``out[r, l] = Σ_{k<LOOP} d[(i[r, l] + k) % 8, l]``, (8, 128)."""
    g = generator(device, seed)
    d = torch.randn((8, 128), generator=g, device=device)
    i = indices(0, 8, (8, 128), g, device)
    fn = functools.partial(gather.take_along, axis=0, loop=LOOP, mod=8)
    return fn, (d, i), LOOP * 8 * 128


def build_row_take(device="cuda", seed=0):
    """P9: ``out = d[i[0, :8], :]``, 8 rows of a (4096, 128) table."""
    g = generator(device, seed)
    d = torch.randn((4096, 128), generator=g, device=device)
    i = indices(0, 4096, (1, 128), g, device)
    return functools.partial(gather.take, row=128), (d, i[0, :8]), 8


PROBES = (
    Probe("P5", "pallas lane take_along 128 (amortized)", build_lane_gather_loop,
          "benchmarks/probe_gather2.py:44"),
    Probe("P6", "pallas lane take_along 1024-wide (amortized)", build_lane_gather_wide,
          "benchmarks/probe_gather2.py:66"),
    Probe("P7", "pallas sublane take_along fullshape 512", build_sublane_gather_fullshape,
          "benchmarks/probe_gather2.py:83", lambda d, i: torch.gather(d, 0, i), "torch.gather"),
    Probe("P8", "pallas sublane take_along 8 (amortized)", build_sublane_gather_8,
          "benchmarks/probe_gather2.py:104"),
    Probe("P9", "pallas row take 8 rows", build_row_take, "benchmarks/probe_gather2.py:122",
          lambda d, i: torch.index_select(d, 0, i), "torch.index_select"),
)


def main(device="cuda"):
    return run(PROBES, device)


if __name__ == "__main__":
    main()
