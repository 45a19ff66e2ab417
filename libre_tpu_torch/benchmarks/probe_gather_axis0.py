"""The probe of ``benchmarks/probe_gather_axis0.py`` (P10) on the card:
``take_along_axis`` on a (128, 128) table along axis 1 and along axis 0,
on the port's hand-written kernel.  Unlike the reference module, nothing
runs at import.

    python -m libre_tpu_torch.benchmarks.probe_gather_axis0
"""

from __future__ import annotations

import functools

import torch

from ..ops import gather
from ._probe import Probe, generator, indices, run

N = 128


def mk(axis, device="cuda", seed=0):
    """P10: ``out = take_along_axis(t, i, axis)`` on (128, 128)."""
    g = generator(device, seed)
    t = torch.rand((N, N), generator=g, device=device)
    i = indices(0, N, (N, N), g, device)
    return functools.partial(gather.take_along, axis=axis), (t, i), N * N


PROBES = tuple(
    Probe(f"P10 axis {axis}", f"axis={axis}", functools.partial(mk, axis),
          "benchmarks/probe_gather_axis0.py:18",
          functools.partial(lambda t, i, axis: torch.gather(t, axis, i), axis=axis),
          "torch.gather")
    for axis in (1, 0)
)


def main(device="cuda"):
    return run(PROBES, device)


if __name__ == "__main__":
    main()
