"""Gathers whose gradient is added into an accumulator, not returned.

Autograd's own backward of ``table[idx]`` allocates a gradient of the
whole table per call: a 512³ volume read at every sample would cost a
512 MiB buffer per plane or chunk.  Here the table is no graph input; a
0-d ``anchor`` that requires grad carries the graph, and the backward
adds the cotangent into ``sink`` (the TF's in float64: a training view
puts tens of millions of samples into a few TF texels, and summed in f32
the reference's own rounding would be the largest error it sees)."""

from __future__ import annotations

import torch


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, table, idx, sink):
        ctx.save_for_backward(idx)
        ctx.sink = sink
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        sink = ctx.sink
        if sink.dim() == 2:  # a few TF texels: a histogram per channel, not contended atomics
            flat, rows = idx.reshape(-1).long(), g.reshape(idx.numel(), -1)
            for c in range(sink.shape[1]):
                sink[:, c] += torch.bincount(flat, weights=rows[:, c].to(sink.dtype),
                                             minlength=sink.shape[0])
        else:
            sink.index_add_(0, idx.reshape(-1), g.reshape(-1).to(sink.dtype))
        return torch.zeros((), device=g.device), None, None, None


class Sinks:
    """The gradient accumulators of one reference pass: ``volume`` (flat,
    f32) and ``tf`` ((T, 4), f64), and the anchor their gathers hang on."""

    def __init__(self, n_voxels: int, n_tf: int, device):
        self.volume = torch.zeros(n_voxels, dtype=torch.float32, device=device)
        self.tf = torch.zeros((n_tf, 4), dtype=torch.float64, device=device)
        self.anchor = torch.zeros((), device=device, requires_grad=True)


def take(table: torch.Tensor, idx: torch.Tensor, sinks, which: str) -> torch.Tensor:
    """``table[idx]``; with ``sinks`` its gradient goes into
    ``getattr(sinks, which)``."""
    if sinks is None:
        return table[idx]
    return _Take.apply(sinks.anchor, table, idx, getattr(sinks, which))
