"""Sharded exact rendering: sort-first ray rows × sort-last brick ranges
(``libre_tpu.parallel.render``).

The reference's two work decompositions (README.md:24, SURVEY.md §2.12)
over a ``(ray, brick)`` mesh (``parallel/mesh.py``):

  * the **ray** axis shards the flat ray batch — no communication, the
    sort-first/tile path (each Equalizer channel renders its viewport);
  * the **brick** axis shards the front-to-back brick list — each shard
    marches only its brick range and the partial (rgb, a) segments are
    over-composited in range order (eq::Compositor::blendFrames,
    Channel.cpp:444-533).

Each shard marches with the exact marcher K3 (``exact.march_exact``,
``csrc/exact_march.cu``; its plain version on CPU tensors) from a zero
carry.  The marcher samples the exact global step grid with half-open
brick ownership, so the fold equals the one-device march up to the early
exit: a shard starts its segment with zero accumulated alpha, so samples
a one-device march would have skipped past the 0.999 threshold are still
composited, but they enter the image scaled by the upstream
transmittance (< 0.001) — early termination is local to a channel, as in
the reference's per-channel DB rendering.

Gradients: a shard's march is ``exact.render_marcher_diff`` over its
brick chunk (K3 forward, K4 over the same set backward), and the fold's
and the moves' autograd carry each segment's cotangent, so the density
gradient of a brick chunk lands on that chunk's device and the TF's is
summed over the shards: the JAX package's ``jax.grad`` through
``shard_map``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops.raycast import brick_boxes, ray_pack, sort_bricks_front_to_back
from libre_tpu_torch.ops.reference import BrickSet, RenderParams
from libre_tpu_torch.parallel.compositing import (
    Streams,
    composite_along_axis_gather,
    join_rgba,
    move,
    on_stream,
    split_rgba,
)
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, Mesh, require_mesh
from libre_tpu_torch.utils.profiling import span


def shard_bricks_front_to_back(
    bricks: BrickSet, eye: np.ndarray, n_shards: int
) -> Tuple[BrickSet, np.ndarray]:
    """Reorder bricks front-to-back and pad to a multiple of ``n_shards``.

    Returns (reordered brick set, original index of each slot; -1 = pad).
    Contiguous chunk d of the reordered list is shard d's range — the
    index-interval split of the sorted visible list (SelectVisibles.cpp:
    120-142), chunk order standing in for Channel::orderFrames.  A pad
    repeats the last brick's data in a unit box FAR outside the scene:
    its ray interval starts beyond any sample's t, so no sample falls in
    it, and its extent keeps the world → texture map finite (an inverted
    box would not do: the slab test normalizes it into a real box)."""
    wmin = bricks.world_min.detach().cpu().numpy()
    wmax = bricks.world_max.detach().cpu().numpy()
    order = sort_bricks_front_to_back(wmin, wmax, eye)
    n = len(order)
    n_pad = (-n) % n_shards
    idx = np.concatenate([order, np.full(n_pad, order[-1])]).astype(np.int64)

    def take(t):
        return t[torch.as_tensor(idx, device=t.device)]

    new_wmin, new_wmax = take(bricks.world_min), take(bricks.world_max)
    if n_pad:
        pad_min = torch.tensor([1e8, 2e8, 3e8], dtype=new_wmin.dtype, device=new_wmin.device)
        pad_min = pad_min.expand(n_pad, 3)
        new_wmin = torch.cat([new_wmin[:n], pad_min])
        new_wmax = torch.cat([new_wmax[:n], pad_min + 1e7])  # extent survives f32 at 1e8
    out = BrickSet(
        data=take(bricks.data),
        world_min=new_wmin,
        world_max=new_wmax,
        tex_min=take(bricks.tex_min),
        tex_max=take(bricks.tex_max),
    )
    slot_to_orig = np.concatenate([order, np.full(n_pad, -1)]).astype(np.int32)
    return out, slot_to_orig


def render_rays_sharded(
    mesh: Mesh,
    bricks: BrickSet,  # front-to-back ordered, num_bricks % brick axis == 0
    tf: torch.Tensor,
    eye: torch.Tensor,
    dirs: torch.Tensor,  # (R, 3), R % ray axis == 0
    t_near_plane: torch.Tensor,  # (R,)
    params: RenderParams,
    global_min,
    global_max,
    max_steps: int,
    clip_planes: Optional[np.ndarray] = None,
    width: Optional[int] = None,
    streams: Streams = None,
    brick_data: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """March rays over a (ray, brick) mesh → (R, 4) on the mesh's lead
    device, differentiable in the f32 brick data and ``tf``.

    ``bricks`` must already be front-to-back ordered
    (:func:`shard_bricks_front_to_back`); brick-axis shard d takes the
    d-th contiguous chunk, and chunk order is the compositing order.
    ``brick_data``, if given, holds per brick shard its chunk's data (a
    trainer's per-shard leaves) in place of ``bricks.data``'s chunks.
    Ray-axis shard vd takes rays [vd·R/d_v, (vd+1)·R/d_v).  ``width`` is
    the screen width K3 and K4 tile each shard's rays by; ``max_steps``
    the longest real brick's march (the pads' boxes are far larger).  K3
    launches once per shard, and K4 once per shard in the backward.

    Spans: ``libre.shard.rays`` (the ray pack, the box rows, the host
    reads of the boxes and the eye, the views' moves) and
    ``libre.shard.composite`` (each ray row's fold and join).
    ``render_rays_sharded.host_reads`` counts the tensors the calls copy
    to the host."""
    require_mesh("render_rays_sharded", mesh)
    d_v, d_k = mesh.shape[RAY_AXIS], mesh.shape[BRICK_AXIS]
    n_rays, n_bricks = dirs.shape[0], bricks.num_bricks
    if n_rays % d_v or n_bricks % d_k:
        raise ValueError(f"R={n_rays} bricks={n_bricks} must divide mesh axes {d_v}x{d_k}")
    r_l, b_l = n_rays // d_v, n_bricks // d_k
    if brick_data is None:
        brick_data = [bricks.data[kd * b_l:(kd + 1) * b_l] for kd in range(d_k)]
    elif [tuple(x.shape) for x in brick_data] != [(b_l, *bricks.data.shape[1:])] * d_k:
        raise ValueError(
            f"render_rays_sharded: brick_data shapes {[tuple(x.shape) for x in brick_data]}, "
            f"want {d_k} chunks of {(b_l, *bricks.data.shape[1:])}"
        )
    lead = mesh.lead
    with span("libre.shard.rays"):
        eye_t = torch.as_tensor(eye, dtype=torch.float32).to(dirs.device)
        pack = ray_pack(
            eye_t, dirs, t_near_plane, params.step_size, global_min, global_max, clip_planes,
        )
        host = [bricks.world_min, bricks.world_max, bricks.tex_min, bricks.tex_max, eye_t]
        render_rays_sharded.host_reads += len(host)
        wmin, wmax, tmin, tmax, eye_host = (x.detach().cpu().numpy() for x in host)
        boxes = brick_boxes(wmin, wmax, tmin, tmax)
        views = {}
        for vd, kd, dev in mesh.shards():
            with on_stream(streams, dev):
                views[vd, kd] = exact.ExactView(
                    ray_pack=move(pack[:, vd * r_l:(vd + 1) * r_l].contiguous(), dev, streams),
                    brick_boxes=move(boxes[kd * b_l:(kd + 1) * b_l].contiguous(), dev, streams),
                    eye=eye_host, max_steps=int(max_steps), width=int(width or r_l),
                    params=params,
                )
    rows = []
    for vd in range(d_v):
        segs = []
        for kd in range(d_k):
            dev = mesh.device(vd, kd)
            with on_stream(streams, dev):
                seg = exact.render_marcher_diff(
                    move(brick_data[kd], dev, streams), move(tf, dev, streams), views[vd, kd]
                )
            segs.append(split_rgba(seg))
        with span("libre.shard.composite"):
            rows.append(join_rgba(composite_along_axis_gather(segs, lead, streams)))
    return torch.cat(rows, dim=0) if d_v > 1 else rows[0]


# The tensors each call copies to the host (the brick boxes and the eye):
# on a card, each a device-to-host read and a synchronise.
render_rays_sharded.host_reads = 0
