"""The over operator on partial ray segments, ordered reductions over the
shards of a mesh axis, and the moves between shards
(``libre_tpu.parallel.compositing``).

Front-to-back emission-absorption compositing is associative: two adjacent
ray segments with premultiplied (rgb, a) states compose as

    over((rgb_f, a_f), (rgb_b, a_b)) = (rgb_f + (1-a_f)·rgb_b,
                                        a_f  + (1-a_f)·a_b)

— the operation eq::Compositor::blendFrames performs on the view-ordered
partial images of a DB (sort-last) decomposition
(livre/eq/Channel.cpp:444-533, orderFrames :535-586).

The JAX package reduces inside ``shard_map`` with collectives; here one
process holds every shard's segment, so each collective is explicit
tensor moves between shards (:func:`move`): a ``psum`` is a sum on one
device, an ``all_to_all`` each owner gathering its subtile from every
shard.  A move is autograd's differentiable copy, so the gradient
exchange of the JAX transpose rules comes with it.

Streams: a cross-device copy in PyTorch orders itself after the CURRENT
streams of both devices, so every move here runs with both devices'
frame streams current (``streams``: device → stream, e.g. the engine's
atlas stream on its device); without ``streams`` the current streams are
used as they are.  On one device a move is the tensor itself.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from libre_tpu_torch.parallel.mesh import as_device

Segment = Tuple[torch.Tensor, torch.Tensor]  # rgb (..., 3), a (...)
Streams = Optional[Dict[torch.device, "torch.cuda.Stream"]]


# =================================================================== moves
def _stream_context(stream):
    return torch.cuda.stream(stream)


def _copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device)


def on_stream(streams: Streams, device) -> contextlib.AbstractContextManager:
    """Make ``device``'s frame stream current (nothing without one)."""
    stream = None if streams is None else streams.get(as_device(device))
    return contextlib.nullcontext() if stream is None else _stream_context(stream)


def move(x: torch.Tensor, device, streams: Streams = None) -> torch.Tensor:
    """``x`` on ``device``: the tensor itself when it is there already,
    else a copy issued with the source's and the destination's frame
    streams current."""
    device = as_device(device)
    if x.device == device:
        return x
    with on_stream(streams, x.device), on_stream(streams, device):
        return _copy(x, device)


# ============================================================ the operator
def over(front: Segment, back: Segment) -> Segment:
    """Compose two ray segments, ``front`` nearer to the eye."""
    rgb_f, a_f = front
    rgb_b, a_b = back
    t = 1.0 - a_f
    return rgb_f + t[..., None] * rgb_b, a_f + t * a_b


def fold_segments(segs: Sequence[Segment]) -> Segment:
    """Fold segments in list order (index 0 frontmost) by a balanced
    reduction of depth log D, the JAX package's pairing."""
    segs = list(segs)
    while len(segs) > 1:
        nxt = [over(segs[i], segs[i + 1]) for i in range(0, len(segs) - 1, 2)]
        if len(segs) % 2:
            nxt.append(segs[-1])
        segs = nxt
    return segs[0]


def fold_over(rgb_parts: torch.Tensor, a_parts: torch.Tensor) -> Segment:
    """Fold (D, R, 3)/(D, R) partials in index order (index 0 frontmost)."""
    return fold_segments([(rgb_parts[i], a_parts[i]) for i in range(rgb_parts.shape[0])])


def split_rgba(x: torch.Tensor) -> Segment:
    """(..., 4) rgba → (rgb (..., 3), a (...))."""
    return x[..., :3], x[..., 3]


def join_rgba(seg: Segment) -> torch.Tensor:
    return torch.cat([seg[0], seg[1][..., None]], dim=-1)


# ====================================================== axis compositing
def composite_along_axis(
    segs: Sequence[Segment], device=None, streams: Streams = None
) -> Segment:
    """Ordered over-reduce of the shards' segments (rank order = front to
    back) by the transmittance prefix product, the form of the JAX
    package's log-step ``ppermute`` scan and two ``psum``s:

        rgb_out = Σ_i P_i · rgb_i,   a_out = Σ_i P_i · a_i,
        P_i = Π_{j<i} (1 − a_j).

    The prefix products and the sums run on ``device`` (default: the
    first segment's), where the result lands."""
    device = torch.device(device) if device is not None else segs[0][1].device
    rgbs = [move(rgb, device, streams) for rgb, _a in segs]
    alphas = [move(a, device, streams) for _rgb, a in segs]
    prefix = torch.ones_like(alphas[0])
    rgb_out, a_out = 0.0, 0.0
    for rgb, a in zip(rgbs, alphas):
        rgb_out = rgb_out + prefix[..., None] * rgb
        a_out = a_out + prefix * a
        prefix = prefix * (1.0 - a)
    return rgb_out, a_out


def composite_along_axis_gather(
    segs: Sequence[Segment], device=None, streams: Streams = None
) -> Segment:
    """Reference form: every segment gathered on ``device`` (default: the
    first segment's) and folded there (:func:`fold_segments`)."""
    device = torch.device(device) if device is not None else segs[0][1].device
    return fold_segments(
        [(move(rgb, device, streams), move(a, device, streams)) for rgb, a in segs]
    )


def composite_direct_send(
    segs: Sequence[Segment], devices: Sequence = None, streams: Streams = None
) -> List[Segment]:
    """Tile-owned ordered composite (direct send, the JAX package's one
    ``all_to_all``): the leading (ray) axis splits into D subtiles, shard
    i OWNS subtile i; each owner gathers its subtile of every shard's
    segment and folds them in rank (march) order.

    Returns the D owned (R/D, ...) tiles, tile i on ``devices[i]``
    (default: each segment's device).  Requires R % D == 0."""
    d = len(segs)
    n = segs[0][1].shape[0]
    if n % d:
        raise ValueError(f"ray tile {n} must divide the axis size {d}")
    devices = [seg[1].device for seg in segs] if devices is None else [
        torch.device(x) for x in devices
    ]
    step = n // d
    owned = []
    for s, dev in enumerate(devices):
        rows = slice(s * step, (s + 1) * step)
        owned.append(fold_segments([
            (move(rgb[rows], dev, streams), move(a[rows], dev, streams)) for rgb, a in segs
        ]))
    return owned
