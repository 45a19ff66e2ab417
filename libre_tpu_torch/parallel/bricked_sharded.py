"""Multi-device bricked sweep: slope rows × plane slabs over the mesh
(``libre_tpu.parallel.bricked_sharded``).

The post-classification store sweep (K1, ``csrc/post_sweep.cu``) gets the
two decomposition axes of every renderer of the framework (SURVEY.md
§2.12):

  * **ray axis** — sort-first: each shard sweeps a contiguous block of
    slope-grid rows (V).  No communication; the shard's kernel differs
    only in its first row's slope ``v0 + vd·V_l·dv`` (the Equalizer
    per-channel viewport split, livre/eq/Channel.cpp:444-533 2D path).
  * **brick axis** — sort-last/DB: the GLOBAL plane grid splits into
    contiguous front-to-back plane ranges; each shard sweeps its range
    with a fresh (rgb, t) carry and the partial segments fold with the
    over operator in rank order (eq::Compositor::blendFrames +
    orderFrames, Channel.cpp:444-533,535-586).  The plane grid is
    global, so a shard's range sees the exact samples of the one-device
    sweep and the fold equals it up to fp regrouping; each shard needs
    only the STORE SLICES its planes bracket (:func:`build_sharded_slabs`),
    1/D of the store on the brick axis.

Early termination stays local to a shard's segment, as in the
reference's per-channel DB rendering: samples a one-device sweep would
have skipped past the threshold are still composited, but they enter the
image scaled by the upstream transmittance (< 1 − early_exit), so the
deviation is bounded by ~1e-3 at the default 0.999.  With the early exit
off (``early_exit`` > 1) the fold matches to fp regrouping.

Each shard launches the same K1 as the one-device path, on tables cut
from the frame's global tables (:func:`shard_tables`, the slicing
``SlabSweep.run_pass`` does for out-of-core passes), with its own fresh
carry: every per-shard tensor is allocated per shard, so logical shards
of one device never share a buffer they write.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.parallel.compositing import (
    Streams,
    composite_along_axis_gather,
    composite_direct_send,
    join_rgba,
    move,
    on_stream,
    split_rgba,
)
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, Mesh, require_mesh


def check_divides(mesh: Mesh, v_size: int, k_planes: int) -> Tuple[int, int]:
    """(V_l, K_l), or a ValueError when V does not divide the ray axis or
    K the brick axis."""
    d_v, d_k = mesh.shape[RAY_AXIS], mesh.shape[BRICK_AXIS]
    if v_size % d_v or k_planes % d_k:
        raise ValueError(f"V={v_size} K={k_planes} must divide mesh axes {d_v}x{d_k}")
    return v_size // d_v, k_planes // d_k


def shard_tables(
    tables: swb.SweepTables,
    *,
    rows: slice,
    planes: slice,
    v0: torch.Tensor,
    device,
    na_store: int,
    a_base: int = 0,
    content: Optional[torch.Tensor] = None,
    streams: Streams = None,
) -> swb.SweepTables:
    """One shard's K1/K5 tables on ``device``, cut from the frame's global
    ``tables``: global planes ``planes`` with their slice indices shifted
    by ``a_base`` into a store of ``na_store`` slices (clamped, as the JAX
    package clamps), slope rows ``rows`` starting at slope ``v0``, plane
    activity from ``content`` (the shard's store's slice flags; all
    active without), and a fresh carry."""
    hi = na_store - 1
    a0 = torch.clamp(tables.a0[planes] - a_base, 0, hi).to(torch.int32)
    a1 = torch.clamp(tables.a1[planes] - a_base, 0, hi).to(torch.int32)
    view = torch.cat([tables.view[:5], v0.reshape(1), tables.view[6:]])
    corr = tables.corr[rows]
    a0, a1, wa, dl, view, corr = (
        move(x.contiguous(), device, streams)
        for x in (a0, a1, tables.wa[planes], tables.dl[planes], view, corr)
    )
    if content is None:
        act = torch.ones(a0.shape, dtype=torch.int32, device=device)
    else:
        act = content[a0.long()] | content[a1.long()]
    v_l, u_size = corr.shape
    return swb.SweepTables(
        a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=view, corr=corr,
        rgb_in=torch.zeros((v_l, u_size, 4), dtype=torch.float32, device=device),
        t_in=torch.ones((v_l, u_size), dtype=torch.float32, device=device),
    )


def fold_rows(
    mesh: Mesh, parts, *, direct: bool, streams: Streams = None
) -> torch.Tensor:
    """``parts[vd][kd]``, each shard's (V_l, U, 4) segment → the (V, U, 4)
    image on the mesh's lead device.  Each row block folds its brick-axis
    segments in rank order: by direct send (each shard owns V_l/d_k rows,
    which land in ray-major, brick-minor order) or by gathering every
    segment on the lead device."""
    lead = mesh.lead
    rows = []
    for vd, row in enumerate(parts):
        segs = [split_rgba(p) for p in row]
        if direct:
            tiles = composite_direct_send(segs, mesh.devices[vd], streams)
            rows += [move(join_rgba(t), lead, streams) for t in tiles]
        else:
            rows.append(join_rgba(composite_along_axis_gather(segs, lead, streams)))
    return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]


def render_store_grid_sharded(
    mesh: Mesh,
    store,  # replicated (Na, Nc, Nb), or in slab mode d_brick slabs
    tf: torch.Tensor,  # (256, 4)
    fv: torch.Tensor,  # view vector (shearwarp_bricked.view_vector), ≥ 11 floats
    *,
    na_real: int,
    nc_real: int,
    nb_real: int,
    k_planes: int,
    inter_size: Tuple[int, int],  # global (V, U)
    wb0: float,
    wb1: float,
    wc0: float,
    wc1: float,
    early_exit: float,
    clip: Optional[torch.Tensor] = None,  # (8, 4) clip rows
    n_clip: int = 0,
    a_base: Optional[Sequence[int]] = None,  # slab mode: per-slab first slice
    content: Optional[torch.Tensor] = None,  # (Na,) slice flags of a replicated store
    streams: Streams = None,
) -> torch.Tensor:
    """→ (V, U, 4) slope-space image on the mesh's lead device, rows
    sharded over the ray axis, plane ranges folded over the brick axis.

    V must divide the ray-axis size and K the brick-axis size (else
    ValueError).  With ``a_base`` (slab mode) ``store`` holds one slab per
    brick-axis shard, slab kd's slice 0 being global slice ``a_base[kd]``;
    shard (vd, kd) reads slab kd.  K1 launches once per shard."""
    require_mesh("render_store_grid_sharded", mesh)
    V, U = inter_size
    d_k = mesh.shape[BRICK_AXIS]
    V_l, K_l = check_divides(mesh, V, k_planes)
    slab_mode = a_base is not None
    if slab_mode and (len(store) != d_k or len(a_base) != d_k):
        raise ValueError(f"slab mode needs {d_k} slabs and offsets, got {len(store)}, {len(a_base)}")
    if clip is None:
        clip = torch.zeros((swb.MAX_CLIP_PLANES, 4), dtype=torch.float32)
    lead = mesh.lead
    fv = move(torch.as_tensor(fv, dtype=torch.float32), lead, streams)
    tables = swb.sweep_tables(fv, na=na_real, k_planes=k_planes, v_size=V, u_size=U)
    dv = tables.view[2]
    kw = dict(n_clip=n_clip, wb=(wb0, wb1), wc=(wc0, wc1), early_exit=early_exit)
    parts = [[None] * d_k for _ in range(mesh.shape[RAY_AXIS])]
    for vd, kd, dev in mesh.shards():
        with on_stream(streams, dev):
            if slab_mode:
                store_l = move(store[kd], dev, streams)
                content_l = swb.store_content(store_l)
                ab = int(a_base[kd])
            else:
                store_l = move(store, dev, streams)
                content_l = None if content is None else move(content, dev, streams)
                ab = 0
            # Sort-first row offset: shard vd's rows start at v0 + vd·V_l·dv.
            v0 = tables.view[5] + float(vd) * (float(V_l) * dv)
            tables_l = shard_tables(
                tables, rows=slice(vd * V_l, (vd + 1) * V_l),
                planes=slice(kd * K_l, (kd + 1) * K_l), v0=v0, device=dev,
                na_store=store_l.shape[0], a_base=ab, content=content_l,
                streams=streams,
            )
            out, _t = swb.post_sweep(
                store_l, move(tf, dev, streams), tables_l,
                move(clip, dev, streams), **kw,
            )
        parts[vd][kd] = out
    # Direct send when each brick-axis shard can own V_l/d_k rows; else
    # gather and fold.
    return fold_rows(mesh, parts, direct=d_k > 1 and V_l % d_k == 0, streams=streams)


def slab_ranges(
    fv: np.ndarray, na: int, k_planes: int, d_k: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per brick-axis shard, the store slice range bracketing its plane
    range → (a_lo (d_k,), a_hi_incl (d_k,), the largest slab's slices),
    from the GLOBAL plane tables: the host half of the sort-last
    decomposition."""
    a0, a1, _wa, _dl, _z, _dz = swb.plane_tables(
        na=na, k_planes=k_planes, wa0=float(fv[0]), wa1=float(fv[1]),
        eye_a=float(fv[2]), sign=float(fv[9]),
    )
    K_l = k_planes // d_k
    lo = np.empty(d_k, np.int32)
    hi = np.empty(d_k, np.int32)
    for d in range(d_k):
        sl = slice(d * K_l, (d + 1) * K_l)
        lo[d] = min(a0[sl].min(), a1[sl].min())
        hi[d] = max(a0[sl].max(), a1[sl].max())
    return lo, hi, int((hi - lo).max()) + 1


def build_sharded_slabs(
    atlas_data: torch.Tensor,
    plan: swb.AssemblyPlan,
    fv: np.ndarray,
    k_planes: int,
    d_k: int,
) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Assemble each brick-axis shard's store slab out of the atlas →
    (d_k slabs on the atlas's device, a_base (d_k,) i32) for
    :func:`render_store_grid_sharded`'s slab mode: shard d holds only the
    slices its plane range brackets (~1/d_k of the store; the reference's
    per-channel Range slicing the visible set, SelectVisibles.cpp:120-142).
    The port's slabs are unpadded, so each has its own slice count."""
    lo, hi, _slab_na = slab_ranges(fv, plan.fine_dims[0], k_planes, d_k)
    slabs = [swb.assemble_store(atlas_data, plan, int(lo[d]), int(hi[d])) for d in range(d_k)]
    return slabs, lo
