"""The exact marcher's plain PyTorch version (``libre_tpu.ops.raycast``):
the specification of ``csrc/exact_march.cu`` (K3).

Semantically identical to :mod:`libre_tpu_torch.ops.reference`: the same
global sample grid ``t_n = tnGlobal + n·step``, the same half-open brick
ownership, opacity-corrected compositing and exact early exit
(fragRaycast.glsl:113-215).  Organised for a tensor library instead of
per sample: a Python loop over the bricks in their front-to-back order,
and per brick, blocks of (rays × ``CHUNK`` samples) that fetch, classify
and fold into the carried (rgb, a) in closed form (``_composite_chunk``).

Its operands are the kernel's, so kernel and plain version see the same
floats:

* the atlas, ``(n_slots, BZ, BY, BX)`` in the dataset's native dtype, and
  one slot per brick of the pass (the kernel reads bricks in place);
* ``brick_boxes``: per brick the world box and the world → padded-texture
  map ``tex = p·s + o`` (raycast.py:202-209 of the JAX package), a
  multiply and an add per axis;
* ``ray_pack``: per ray the direction, near-plane t, global entry t, first
  admissible sample index and clip interval, computed by ``ops/rays``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.reference import (
    ALPHA_CLAMP,
    BrickSet,
    Camera,
    RenderParams,
    max_steps_for_bricks,
)

# Rows of ``ray_pack``.
PACK_ROWS = ("dx", "dy", "dz", "t_near_plane", "tn_global", "n_start", "t_lo", "t_hi")
# Floats per brick in ``brick_boxes``: four float4 rows
# (wmin.xyz wmax.x | wmax.yz 0 0 | s.xyz o.x | o.yz 0 0).
BOX_FLOATS = 16
# The plain march works on blocks of RAY_BLOCK rays × CHUNK samples.
CHUNK = 32
RAY_BLOCK = 16384


def ray_pack(
    eye: torch.Tensor,
    dirs: torch.Tensor,
    t_near_plane: torch.Tensor,
    step: float,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Per-ray constants of the march → (8, R) f32, rows ``PACK_ROWS``.

    ``n_start`` is the first sample past the near plane
    (fragRaycast.glsl:149-150), a whole number in f32.  (t_lo, t_hi] is the
    clip interval (fragRaycast.glsl:162-174); a ray that misses the global
    box gets an empty one (t_lo = +inf), so no brick takes a sample of it.
    """
    tn_global, _t1, hit_global = ray_ops.intersect_box(
        eye, dirs, global_min, global_max
    )
    n_start = torch.ceil(torch.clamp(t_near_plane - tn_global, min=0.0) / step)
    big = torch.full_like(tn_global, 3e38)
    t_lo, t_hi = -big, big
    if clip_planes is not None and len(clip_planes) > 0:
        t_lo, t_hi = ray_ops.clip_ray(eye, dirs, t_lo, t_hi, clip_planes)
    t_lo = torch.where(hit_global, t_lo, torch.full_like(t_lo, float("inf")))
    return torch.stack(
        [dirs[:, 0], dirs[:, 1], dirs[:, 2], t_near_plane, tn_global, n_start,
         t_lo, t_hi]
    ).contiguous()


def brick_boxes(world_min, world_max, tex_min, tex_max) -> torch.Tensor:
    """(B, 3) world boxes and padded-texture insets → (B, 16) f32 CPU
    tensor of ``BOX_FLOATS``: the box and the map ``tex = p·s + o`` with
    ``s = (tmax − tmin)/(wmax − wmin)``, ``o = tmin − wmin·s``."""

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(-1, 3))

    wmin, wmax, tmin, tmax = f32(world_min), f32(world_max), f32(tex_min), f32(tex_max)
    s = (tmax - tmin) / (wmax - wmin)
    o = tmin - wmin * s
    zero = torch.zeros((wmin.shape[0], 2))
    return torch.cat(
        [wmin, wmax[:, :1], wmax[:, 1:], zero, s, o[:, :1], o[:, 1:], zero], dim=1
    ).contiguous()


def _exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """prod_{j<i} x_j along dim 1 (1 at index 0)."""
    cp = torch.cumprod(x, dim=1)
    return torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)


def _composite_chunk(carry, src_r, src_g, src_b, alpha, valid, early_exit):
    """Fold one (R, C) chunk of samples into the (r, g, b, a) carry, in
    closed form.

    Equivalent to compositing the samples serially front-to-back with the
    reference's early-exit rule (skip a sample iff the accumulated alpha
    before it exceeds ``early_exit``).  Alpha is monotone, so the exact
    early-exit mask follows from the prefix transmittance of the valid
    samples.  Returns (carry, the (R, C) mask of composited samples).
    """
    r, g, b, a = carry
    alpha_v = alpha * valid.to(alpha.dtype)
    t_excl_u = _exclusive_cumprod(1.0 - alpha_v)
    global_before = a[:, None] + (1.0 - a[:, None]) * (1.0 - t_excl_u)
    m = global_before <= early_exit
    alpha_eff = alpha_v * m.to(alpha_v.dtype)
    w = alpha_eff * _exclusive_cumprod(1.0 - alpha_eff)
    chunk_trans = torch.prod(1.0 - alpha_eff, dim=1)
    one_minus_a = 1.0 - a
    r = r + one_minus_a * torch.sum(w * src_r, dim=1)
    g = g + one_minus_a * torch.sum(w * src_g, dim=1)
    b = b + one_minus_a * torch.sum(w * src_b, dim=1)
    a = a + one_minus_a * (1.0 - chunk_trans)
    return (r, g, b, a), valid & m


def _tf_lookup_channels(tf: torch.Tensor, density: torch.Tensor):
    """GL linear 1-D TF lookup, channelwise: (T, 4) × (R, C) → 4× (R, C)."""
    n = tf.shape[0]
    s = torch.clamp(density, 0.0, 1.0) * n - 0.5
    s = torch.clamp(s, 0.0, float(n - 1))
    i0f = torch.floor(s)
    w = s - i0f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return [tf[i0, c] * (1.0 - w) + tf[i1, c] * w for c in range(4)]


def _cell(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer voxel index, clamped to [0, dim − 1] after the conversion
    (the samples a mask drops may lie far outside the brick)."""
    return x.long().clamp(0, dim - 1)


def _fetch_nearest(brick_flat, tex_x, tex_y, tex_z, dims_xyz):
    bx, by, bz = dims_xyz
    ix = _cell(torch.floor(tex_x * bx), bx)
    iy = _cell(torch.floor(tex_y * by), by)
    iz = _cell(torch.floor(tex_z * bz), bz)
    return brick_flat[(iz * by + iy) * bx + ix]


def _fetch_trilinear(brick_flat, tex_x, tex_y, tex_z, dims_xyz):
    bx, by, bz = dims_xyz

    def prep(tex, dim):
        s = torch.clamp(tex * dim - 0.5, 0.0, dim - 1.0)
        i0f = torch.floor(s)
        w = s - i0f
        i0 = _cell(i0f, dim)
        return i0, torch.clamp(i0 + 1, max=dim - 1), w

    ix0, ix1, wx = prep(tex_x, bx)
    iy0, iy1, wy = prep(tex_y, by)
    iz0, iz1, wz = prep(tex_z, bz)
    out = 0.0
    for dxb in (0, 1):
        for dyb in (0, 1):
            for dzb in (0, 1):
                ix = ix1 if dxb else ix0
                iy = iy1 if dyb else iy0
                iz = iz1 if dzb else iz0
                wgt = (
                    (wx if dxb else 1.0 - wx)
                    * (wy if dyb else 1.0 - wy)
                    * (wz if dzb else 1.0 - wz)
                )
                out = out + brick_flat[(iz * by + iy) * bx + ix] * wgt
    return out


def march_exact_reference(
    atlas: torch.Tensor,
    slots: torch.Tensor,
    boxes: torch.Tensor,
    tf: torch.Tensor,
    rays: torch.Tensor,
    carry: torch.Tensor,
    eye,
    params: RenderParams,
    *,
    max_steps: int,
    samples: Optional[torch.Tensor] = None,
    used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch exact march of one pass: the specification of K3.

    ``atlas`` (n_slots, BZ, BY, BX), any dtype; ``slots`` (B,) int32, the
    pass's bricks in front-to-back order; ``boxes`` (B, 16) f32 from
    :func:`brick_boxes`; ``tf`` (256, 4) f32; ``rays`` (8, R) f32 from
    :func:`ray_pack`; ``carry`` (R, 4) f32 rgba from earlier passes;
    ``eye`` 3 floats.  Returns the (R, 4) carry after this pass.

    Per brick and ray, with (t0, t1] the ray's slab interval of the
    brick, lo = max(t0, t_lo), hi = min(t1, t_hi) and
    n0 = floor((max(lo, t_near_plane) − tn_global)/step) − 1 (a lower
    bound on the first member sample), the samples
    n0 ≤ n < n0 + ``max_steps`` with n ≥ n_start and
    t_n = tn_global + n·step ∈ (lo, hi] are fetched (nearest or
    trilinear at ``tex = (eye + dir·t)·s + o``), normalised by the data
    range, classified by the linear TF lookup, opacity-corrected
    ``1 − (1 − min(a, 1 − 1/256))^corr`` and composited front to back
    while the accumulated alpha before the sample is ≤ ``early_exit``.
    ``max_steps`` must cover the longest brick diagonal
    (``reference.max_steps_for_bricks``).

    ``samples`` ((R,) int32) and ``used`` ((B,) int32), if given, count
    the samples each ray composites and flag (1) the bricks that
    composite any.
    """
    dev = carry.device
    step = params.step_size
    lo_, hi_ = params.data_source_range
    mult = 1.0 / (hi_ - lo_)
    add = -lo_ / (hi_ - lo_)
    bz, by, bx = atlas.shape[1:]
    fetch = _fetch_trilinear if params.filter_mode == "trilinear" else _fetch_nearest
    ex, ey, ez = (float(v) for v in eye)
    eye_t = torch.tensor([ex, ey, ez], dtype=torch.float32, device=dev)
    slot_list = slots.tolist()
    box_rows = boxes.cpu()
    n_chunks = -(-max_steps // CHUNK)
    k_base = torch.arange(CHUNK, dtype=torch.int32, device=dev)

    out = carry.clone()
    for r0 in range(0, carry.shape[0], RAY_BLOCK):
        sl = slice(r0, r0 + RAY_BLOCK)
        dx, dy, dz, tnp, tng, n_start_f, t_lo, t_hi = rays[:, sl]
        dirs = torch.stack([dx, dy, dz], dim=-1)
        n_start = n_start_f.to(torch.int32)
        c = out[sl]
        state = (c[:, 0], c[:, 1], c[:, 2], c[:, 3])
        count = torch.zeros_like(n_start)
        for b, slot in enumerate(slot_list):
            wmin, wmax = box_rows[b, 0:3], box_rows[b, 3:6]
            sx, sy, sz, ox, oy, oz = box_rows[b, 8:14].tolist()
            t0, t1, _hit = ray_ops.intersect_box(eye_t, dirs, wmin, wmax)
            lo = torch.maximum(t0, t_lo)
            hi = torch.minimum(t1, t_hi)
            if not bool((lo < hi).any()):
                continue
            n0 = torch.floor((torch.maximum(lo, tnp) - tng) / step).to(torch.int32) - 1
            brick_flat = atlas[slot].reshape(-1).float()
            brick_count = torch.zeros_like(n_start)
            for ci in range(n_chunks):
                n = n0[:, None] + (ci * CHUNK + k_base)[None, :]  # (R, C)
                t = tng[:, None] + n.to(torch.float32) * step
                valid = (
                    (t > lo[:, None]) & (t <= hi[:, None]) & (n >= n_start[:, None])
                )
                tex_x = (ex + dx[:, None] * t) * sx + ox
                tex_y = (ey + dy[:, None] * t) * sy + oy
                tex_z = (ez + dz[:, None] * t) * sz + oz
                raw = fetch(brick_flat, tex_x, tex_y, tex_z, (bx, by, bz))
                density = torch.clamp(raw * mult + add, 0.0, 1.0)
                src_r, src_g, src_b, src_a = _tf_lookup_channels(tf, density)
                alpha = 1.0 - torch.pow(
                    1.0 - torch.clamp(src_a, max=ALPHA_CLAMP), params.alpha_correction
                )
                state, took = _composite_chunk(
                    state, src_r, src_g, src_b, alpha, valid, params.early_exit
                )
                brick_count += took.sum(dim=1, dtype=torch.int32)
            count += brick_count
            if used is not None and bool((brick_count > 0).any()):
                used[b] = 1
        out[sl] = torch.stack(state, dim=-1)
        if samples is not None:
            samples[sl] += count
    return out


def render_rays(
    bricks: BrickSet,
    tf: torch.Tensor,
    eye: torch.Tensor,
    dirs: torch.Tensor,  # (R, 3)
    t_near_plane: torch.Tensor,  # (R,)
    params: RenderParams,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
    brick_order: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """March a flat batch of rays through a brick set → (R, 4), with the
    plain version on the device of ``dirs``.  ``brick_order`` is the
    front-to-back order (defaults to range(N), i.e. bricks already
    sorted)."""
    dev = dirs.device
    wmin = bricks.world_min.cpu().numpy()
    wmax = bricks.world_max.cpu().numpy()
    order = range(bricks.num_bricks) if brick_order is None else brick_order
    slots = torch.as_tensor(np.asarray(order, np.int32))
    boxes = brick_boxes(
        wmin, wmax, bricks.tex_min.cpu().numpy(), bricks.tex_max.cpu().numpy()
    )[slots.long()]
    pack = ray_pack(
        eye, dirs, t_near_plane, params.step_size, global_min, global_max,
        clip_planes,
    )
    return march_exact_reference(
        bricks.data, slots, boxes, tf.to(dev), pack,
        torch.zeros((dirs.shape[0], 4), device=dev), eye.cpu().tolist(), params,
        max_steps=max_steps_for_bricks(wmin, wmax, params.step_size),
    )


def render(
    bricks: BrickSet,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Render to an (H, W, 4) image (bottom-up rows, like GL) on the device
    of ``bricks.data``, the bricks in their given order."""
    vx, vy, vw, vh = camera.viewport
    images = []
    for s in range(params.samples_per_pixel):
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport, sample_index=s,
            device=bricks.data.device,
        )
        dirs = dirs.reshape(-1, 3)
        tnp_ = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
        images.append(render_rays(
            bricks, tf, eye, dirs, tnp_, params, global_min, global_max,
            clip_planes,
        ))
    out = sum(images) / float(params.samples_per_pixel)
    return out.reshape(vh, vw, 4)


def sort_bricks_front_to_back(
    world_min: np.ndarray, world_max: np.ndarray, eye: np.ndarray
) -> np.ndarray:
    """Host-side front-to-back brick order by center distance
    (GLRaycastPipeline.cpp:106-126 DistanceOperator); stable, so ties keep
    their input order."""
    centers = (np.asarray(world_min) + np.asarray(world_max)) * 0.5
    dist = np.linalg.norm(centers - np.asarray(eye), axis=-1)
    return np.argsort(dist, kind="stable")
