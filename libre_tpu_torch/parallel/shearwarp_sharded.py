"""Multi-device dense shear-warp: slope rows × plane ranges over the mesh
(``libre_tpu.parallel.shearwarp_sharded``).

The same two decomposition axes as the marcher (SURVEY.md §2.12), mapped
onto the plain shear-warp pipeline:

  * **ray axis** shards the slope-grid rows (V) — sort-first tiles, no
    communication;
  * **brick axis** shards the plane stack (K) into contiguous
    front-to-back ranges — the ray-segment (sort-last/DB) axis; each
    shard composites its plane range in closed form and the partial
    (rgb, a) segments fold with the over operator in rank order
    (eq::Compositor::blendFrames, Channel.cpp:444-533).

A shard's work is the batched-product pipeline of
``ops/shearwarp.render_slope_grid`` (axis lerp, two-tap resampling as
products, closed-form composite; no kernel, as in the JAX package) with
its plane and row ranges selected by its mesh coordinates.  The volume
and the TF are replicated by autograd's copies, so their gradients sum
onto the caller's device.  Unlike the JAX package's, which always
pre-classifies, the classification follows ``swp.classification`` as the
one-device pipeline does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.ops.shearwarp import (
    _BC_AXES,
    _PERM,
    ShearWarpParams,
    _composite_planes,
    _lerp_matrix,
    precompute_classified_volume,
)
from libre_tpu_torch.ops.transfer_function import lookup
from libre_tpu_torch.parallel.compositing import (
    Streams,
    composite_along_axis_gather,
    join_rgba,
    move,
    on_stream,
    split_rgba,
)
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, Mesh, require_mesh


def render_slope_grid_sharded(
    mesh: Mesh,
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    eye,
    axis: int,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: ShearWarpParams,
    streams: Streams = None,
) -> torch.Tensor:
    """→ (V, U, 4) slope-space image on the mesh's lead device, V sharded
    over the ray axis, the planes folded over the brick axis.  V must
    divide the ray-axis size and K the brick-axis size (else
    ValueError)."""
    require_mesh("render_slope_grid_sharded", mesh)
    f32 = torch.float32
    K = swp.n_planes
    V, U = swp.inter_size
    d_k, d_v = mesh.shape[BRICK_AXIS], mesh.shape[RAY_AXIS]
    if V % d_v or K % d_k:
        raise ValueError(f"V={V} K={K} must divide mesh axes {d_v}x{d_k}")
    K_l, V_l = K // d_k, V // d_v

    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    eye = np.asarray(eye, np.float32)
    perm = _PERM[axis]
    b_axis, c_axis = _BC_AXES[axis]
    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    wb0, wb1 = float(wmin[b_axis]), float(wmax[b_axis])
    wc0, wc1 = float(wmin[c_axis]), float(wmax[c_axis])
    u0, u1, v0, v1 = slope_bounds
    dz = (wa1 - wa0) / K
    pre = swp.classification == "pre"

    # Classified (or normalized) once on the volume's device, replicated
    # to the shards, as the JAX package classifies outside shard_map.
    if pre:
        chans = precompute_classified_volume(volume_zyx, tf, params.data_source_range)
    else:
        lo, hi = params.data_source_range
        chans = [(volume_zyx.to(f32) - lo) / (hi - lo)]
    chans = torch.stack([ch.permute(perm) for ch in chans])  # (channels, A, C, B)
    na, nc, nb = chans.shape[1:]

    def body(vd, kd, dev):
        chans_l = move(chans, dev, streams)
        tf_l = move(tf, dev, streams)
        ea, eb, ec = (torch.tensor(float(eye[i]), dtype=f32, device=dev)
                      for i in (axis, b_axis, c_axis))
        # Shard kd's contiguous front-to-back range of the GLOBAL planes.
        j = (kd * K_l + torch.arange(K_l, device=dev)).to(f32)
        z = wa0 + (j + 0.5) * dz if sign > 0 else wa1 - (j + 0.5) * dz
        ug = torch.linspace(u0, u1, U, dtype=f32, device=dev)
        vg = v0 + (v1 - v0) * ((vd * V_l + torch.arange(V_l, device=dev)).to(f32) / (V - 1))

        sa = (z - wa0) / (wa1 - wa0) * na - 0.5
        A = _lerp_matrix(sa[None, :], na, torch.ones((1, K_l), dtype=f32, device=dev))[0].T
        delta = (z - ea)[:, None]
        xb = eb + ug[None, :] * delta
        inside_b = ((xb >= wb0) & (xb < wb1)).to(f32)
        Mb = _lerp_matrix((xb - wb0) / (wb1 - wb0) * nb - 0.5, nb, inside_b)
        xc = ec + vg[None, :] * delta
        inside_c = ((xc >= wc0) & (xc < wc1)).to(f32)
        Mc = _lerp_matrix((xc - wc0) / (wc1 - wc0) * nc - 0.5, nc, inside_c)

        slabs = []
        for ch in chans_l:
            vs = torch.einsum("ka,acb->kcb", A, ch)
            s1 = torch.einsum("kcb,kbu->kcu", vs, Mb)
            slabs.append(torch.einsum("kcu,kcv->kvu", s1, Mc))
        if not pre:
            rgba = lookup(tf_l, slabs[0])
            inside = inside_c[:, :, None] * inside_b[:, None, :]
            slabs = [rgba[..., 0], rgba[..., 1], rgba[..., 2], rgba[..., 3] * inside]
        length = torch.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
        corr = params.max_samples_per_ray * dz * length
        return torch.stack(_composite_planes(*slabs, corr, params.early_exit), dim=-1)

    rows = []
    for vd in range(d_v):
        segs = []
        for kd in range(d_k):
            dev = mesh.device(vd, kd)
            with on_stream(streams, dev):
                segs.append(split_rgba(body(vd, kd, dev)))
        # Rank order is plane order: fold front to back on the lead device.
        rows.append(join_rgba(composite_along_axis_gather(segs, mesh.lead, streams)))
    return torch.cat(rows, dim=0) if d_v > 1 else rows[0]
