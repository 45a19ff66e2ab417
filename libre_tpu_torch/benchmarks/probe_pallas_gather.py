"""Gather probes of ``benchmarks/probe_pallas_gather.py`` (P14-P17) on the
card: a flat take from a 32 768-entry table, the same lookup by (row,
lane) of its (256, 128) view, a lane gather with one index per row, and
the nearest (256, 4) TF lookup that the TPU did as a one-hot matrix
product, each on the port's hand-written kernels.  The reference's XLA
take is not a kernel: P14 prints ``torch.take``'s time instead.

    python -m libre_tpu_torch.benchmarks.probe_pallas_gather
"""

from __future__ import annotations

import functools

import torch

from ..ops import gather
from ._probe import Probe, generator, indices, run

R, C = 1024, 128
V = 32 * 32 * 32


def _table_and_idx(device, seed):
    g = generator(device, seed)
    table = torch.rand((V,), generator=g, device=device)
    return g, table, indices(0, V, (R, C), g, device)


def build_take_flat(device="cuda", seed=0):
    """P14: ``out = t[i]``, t (V,), i (R, C)."""
    _g, table, idx = _table_and_idx(device, seed)
    return functools.partial(gather.take), (table, idx), R * C


def build_take_2d_table(device="cuda", seed=0):
    """P15: the same lookup from t (256, 128) by (i // 128, i % 128); the
    kernel forms the flat index."""
    _g, table, idx = _table_and_idx(device, seed)
    return functools.partial(gather.take), (table.reshape(V // 128, 128), idx // 128, idx % 128), R * C


def build_take_along_lanes(device="cuda", seed=0):
    """P16: ``out[r, 0] = t[r, li[r, 0]]``, t the first 128 entries
    replicated per row (R, 128), li (R, 1)."""
    _g, table, idx = _table_and_idx(device, seed)
    t2 = table[:128].expand(R, 128).contiguous()
    li = (idx[:, :1] % 128).contiguous()
    return functools.partial(gather.take_along, axis=1), (t2, li), R


def build_onehot_tf(device="cuda", seed=0):
    """P17: ``out[r, c, :] = tf[⌊d·255⌋]``, 0 outside [0, 256); tf (256, 4),
    d (R, C) → (R, C, 4)."""
    g = generator(device, seed)
    tf = torch.rand((256, 4), generator=g, device=device)
    d = torch.rand((R, C), generator=g, device=device)
    fn = functools.partial(gather.tf_nearest, scale=255.0, outside="zero")
    return fn, (d, tf), R * C * 4


PROBES = (
    Probe("P14", "pallas_take_flat", build_take_flat, "benchmarks/probe_pallas_gather.py:53",
          lambda t, i: torch.take(t, i), "torch.take"),
    Probe("P15", "pallas_take_2d", build_take_2d_table, "benchmarks/probe_pallas_gather.py:78",
          lambda t, r, l: t[r, l], "advanced index t[r, l]"),
    Probe("P16", "pallas_take_lanes", build_take_along_lanes,
          "benchmarks/probe_pallas_gather.py:98", lambda t, i: torch.gather(t, 1, i),
          "torch.gather"),
    Probe("P17", "pallas_onehot_tf", build_onehot_tf, "benchmarks/probe_pallas_gather.py:128"),
)


def main(device="cuda"):
    return run(PROBES, device)


if __name__ == "__main__":
    main()
