"""Brick-atlas-native shear-warp frame (``libre_tpu.ops.shearwarp_bricked``).

Pipeline per frame, all on the frame's device:

1. **Assembly** (:func:`assemble_store`, plain torch): gather the
   rendering set's bricks of each LOD level out of the atlas, cast the
   native dtype to f32, strip ghost voxels, tile them into the
   axis-permuted render-level grid, upsample coarser levels with two-tap
   interpolation (f32 matmuls), blend seam-free by normalized
   convolution (value and coverage upsampled together) under the
   rendering set's per-level ownership masks, normalize by the data
   range.  Output: an unpadded ``(Na, Nc, Nb)`` f32 density store with
   :data:`SENTINEL` where no brick covers.
2. **Sweep** (:func:`post_sweep`): the front-to-back sweep of K virtual
   axis planes over a (V, U) slope-ray grid with per-sample
   post-classification, clip planes, opacity correction and the exact
   early exit — the hand-written CUDA kernel ``csrc/post_sweep.cu`` on a
   GPU, :func:`post_sweep_reference` on the CPU.
3. **Warp** (``shearwarp.warp_frame_device``): slope grid → screen.

The per-frame tables of the sweep (plane tables, plane activity, opacity
correction, carry) are derived on the device from one 43-float view
vector (:func:`sweep_tables`), so a steady-state frame moves only that
vector host → device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops.reference import ALPHA_CLAMP, RenderParams
from libre_tpu_torch.ops.transfer_function import lookup

SENTINEL = -1024.0  # uncovered-voxel marker (normalized density is [0,1])
TF_SIZE = 256
MAX_CLIP_PLANES = 8


# ================================================================= host plan
def clip_matrix(
    clip_planes_world: Optional[np.ndarray], axis: int
) -> Tuple[np.ndarray, int]:
    """(8, 4) clip-plane rows [n_a, n_b, n_c, d] reordered for the major
    axis, zero-padded; returns (matrix, n_clip).  Plane convention: keep
    the half-space n·x + d ≥ 0 (core/clip_planes.py)."""
    m = np.zeros((MAX_CLIP_PLANES, 4), np.float32)
    if clip_planes_world is None or len(clip_planes_world) == 0:
        return m, 0
    b_axis, c_axis = sw._BC_AXES[axis]
    cp = np.asarray(clip_planes_world, np.float32).reshape(-1, 4)
    n = min(len(cp), MAX_CLIP_PLANES)
    for i in range(n):
        nvec = cp[i, :3]
        m[i] = (nvec[axis], nvec[b_axis], nvec[c_axis], cp[i, 3])
    return m, n


def plane_tables(
    *,
    na: int,
    k_planes: int,
    wa0: float,
    wa1: float,
    eye_a: float,
    sign: float,
):
    """Front-to-back plane tables (numpy): bracketing slice indices a0
    and a1 (clamped at the volume edge), axis lerp weight, z − eye_a,
    plane z, and the plane spacing dz.  The host form of
    :func:`sweep_tables`."""
    dz = (wa1 - wa0) / k_planes
    j = np.arange(k_planes, dtype=np.float32)
    z = np.where(sign > 0, wa0 + (j + 0.5) * dz, wa1 - (j + 0.5) * dz)
    sa = np.clip((z - wa0) / (wa1 - wa0) * na - 0.5, -0.5, na - 0.5)
    i0 = np.floor(np.clip(sa, 0.0, float(na - 1)))
    wa = np.clip(sa - i0, 0.0, 1.0).astype(np.float32)
    a0 = i0.astype(np.int32)
    a1 = np.minimum(a0 + 1, na - 1).astype(np.int32)
    return a0, a1, wa, (z - eye_a).astype(np.float32), z.astype(np.float32), dz


@dataclasses.dataclass(frozen=True)
class LevelTables:
    """Per-level assembly tables in permuted (A, C, B) tile order."""

    level: int
    factor: int  # 2^(render_level − level)
    slots: np.ndarray  # (ta, tc, tb) i32 atlas slot per tile (0 if absent)
    resident: np.ndarray  # (ta, tc, tb) f32 1 = brick resident
    own: np.ndarray  # (ta, tc, tb) f32 1 = rendering set assigns this level
    dims: Tuple[int, int, int]  # level voxel dims (A_l, C_l, B_l)


@dataclasses.dataclass(frozen=True)
class AssemblyPlan:
    """Per-(dataset, axis, rendering set) assembly description."""

    axis: int
    render_level: int
    fine_dims: Tuple[int, int, int]  # (Na, Nc, Nb) render-level grid
    block: Tuple[int, int, int]  # interior block (ba, bc, bb) permuted
    padded_zyx: Tuple[int, int, int]  # padded brick (BZ, BY, BX) array order
    overlap: Tuple[int, int, int]  # (oa, oc, ob) permuted
    levels: Tuple[LevelTables, ...]
    lo: float  # data_source_range normalization
    hi: float


def _permute_xyz(t_xyz, perm):
    """World-axis-ordered (x, y, z) triple → permuted array order
    (a, c, b): volume arrays are (Z, Y, X), perm maps array dims."""
    zyx = (t_xyz[2], t_xyz[1], t_xyz[0])
    return tuple(zyx[p] for p in perm)


def build_assembly_plan(
    datasource,
    rendering_set: Sequence,  # NodeIds
    axis: int,
    slot_of,  # NodeId -> atlas slot (must be resident)
    data_source_range: Tuple[float, float],
    render_level: Optional[int] = None,
) -> AssemblyPlan:
    """Group the rendering set by level and build full tile-grid
    slot/resident/ownership tables in permuted (A, C, B) order."""
    info = datasource.volume_info
    perm = sw._PERM[axis]
    depth = info.root_node.depth
    by_level: Dict[int, list] = {}
    for n in rendering_set:
        by_level.setdefault(n.level, []).append(n)
    if render_level is None:
        render_level = max(by_level)

    shift = depth - 1 - render_level
    fine_xyz = tuple(max(1, d >> shift) for d in info.voxels)
    fine_dims = _permute_xyz(fine_xyz, perm)
    block = _permute_xyz(info.block_size, perm)
    overlap = _permute_xyz(info.overlap, perm)
    mbs = info.maximum_block_size  # (x, y, z)
    padded_zyx = (mbs[2], mbs[1], mbs[0])
    bx, by_, bz = info.block_size

    levels = []
    for level in sorted(by_level):
        lshift = depth - 1 - level
        lvx, lvy, lvz = (max(1, d >> lshift) for d in info.voxels)
        tx, ty, tz = (-(-lvx // bx), -(-lvy // by_), -(-lvz // bz))
        ta, tc, tb = _permute_xyz((tx, ty, tz), perm)
        slots = np.zeros((ta, tc, tb), np.int32)
        resident = np.zeros((ta, tc, tb), np.float32)
        own = np.zeros((ta, tc, tb), np.float32)
        for node in by_level[level]:
            pa, pc, pb = _permute_xyz(node.position, perm)
            slots[pa, pc, pb] = slot_of(node)
            resident[pa, pc, pb] = 1.0
            own[pa, pc, pb] = 1.0
        levels.append(
            LevelTables(
                level=level,
                factor=1 << (render_level - level),
                slots=slots,
                resident=resident,
                own=own,
                dims=_permute_xyz((lvx, lvy, lvz), perm),
            )
        )
    lo, hi = data_source_range
    return AssemblyPlan(
        axis=axis,
        render_level=render_level,
        fine_dims=fine_dims,
        block=block,
        padded_zyx=padded_zyx,
        overlap=overlap,
        levels=tuple(levels),
        lo=float(lo),
        hi=float(hi),
    )


def _upsample_matrix(
    n_fine: int,
    n_coarse: int,
    f_lo: int,
    f_hi_incl: int,
    c_base: int,
    c_count: int,
) -> np.ndarray:
    """(fine rows f_lo..f_hi_incl, c_count) two-tap matrix sampling the
    coarse grid (rows c_base..c_base+c_count of the full coarse axis) at
    fine voxel centers, clamp-to-edge against the FULL coarse axis."""
    j = np.arange(f_lo, f_hi_incl + 1, dtype=np.float64)
    s = (j + 0.5) * (n_coarse / n_fine) - 0.5
    s = np.clip(s, 0.0, n_coarse - 1.0)
    i0 = np.floor(s).astype(np.int64)
    w = s - i0
    i1 = np.minimum(i0 + 1, n_coarse - 1)
    m = np.zeros((len(j), c_count), np.float32)
    rows = np.arange(len(j))
    m[rows, np.clip(i0 - c_base, 0, c_count - 1)] += (1.0 - w).astype(
        np.float32
    )
    m[rows, np.clip(i1 - c_base, 0, c_count - 1)] += w.astype(np.float32)
    return m


# ================================================================== assembly
def assemble_store(
    atlas_data: torch.Tensor,
    plan: AssemblyPlan,
    a_lo: int = 0,
    a_hi_incl: Optional[int] = None,
) -> torch.Tensor:
    """Assemble render-level slices [a_lo, a_hi_incl] from the atlas
    ((n_slots, BZ, BY, BX), any dtype) → (slices, Nc, Nb) f32 normalized
    density on the atlas's device, SENTINEL outside coverage.  Per level
    only the tile layers the slices touch are gathered (+1 guard layer
    for the upsample taps)."""
    dev = atlas_data.device
    f32 = torch.float32
    na, nc, nb = plan.fine_dims
    if a_hi_incl is None:
        a_hi_incl = na - 1
    a_hi_incl = min(a_hi_incl, na - 1)
    s_count = a_hi_incl - a_lo + 1
    perm = sw._PERM[plan.axis]
    oa, oc, ob = plan.overlap
    ba, bc, bb = plan.block

    def dev_tensor(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev, dtype)

    num = None
    den = None
    for lt in plan.levels:
        da_l, dc_l, db_l = lt.dims
        f = lt.factor
        _ta, tc, tb = lt.slots.shape
        c_lo_vox = max(0, int(np.floor((a_lo + 0.5) / f - 0.5)) - 1)
        c_hi_vox = min(
            da_l - 1, int(np.ceil((a_hi_incl + 0.5) / f - 0.5)) + 1
        )
        l_lo = c_lo_vox // ba
        l_hi = c_hi_vox // ba  # inclusive
        layers = l_hi - l_lo + 1
        c_base = l_lo * ba
        sl = slice(l_lo, l_hi + 1)
        slots = dev_tensor(lt.slots[sl].reshape(-1), torch.int64)
        resident = dev_tensor(lt.resident[sl], f32)  # (layers, tc, tb)
        own_tiles = dev_tensor(lt.own[sl], f32)

        bricks = atlas_data.index_select(0, slots).to(f32)
        # (n, BZ, BY, BX) → (n, pa, pc, pb) permuted brick dims.
        bricks = bricks.permute((0,) + tuple(p + 1 for p in perm))
        cores = bricks[:, oa : oa + ba, oc : oc + bc, ob : ob + bb]
        vals = cores * resident.reshape(-1, 1, 1, 1)
        grid = vals.reshape(layers, tc, tb, ba, bc, bb)
        grid = grid.permute(0, 3, 1, 4, 2, 5).reshape(
            layers * ba, tc * bc, tb * bb
        )[:, :dc_l, :db_l]
        cov = resident[:, None, :, None, :, None].expand(
            layers, ba, tc, bc, tb, bb
        ).reshape(layers * ba, tc * bc, tb * bb)[:, :dc_l, :db_l]

        if f == 1:
            a_off = a_lo - c_base
            v_up = grid[a_off : a_off + s_count]
            c_up = cov[a_off : a_off + s_count]
        else:
            # f32 products on purpose: the upsample must be exact so the
            # mixed-LOD store matches the trilinear oracle.
            amat = dev_tensor(
                _upsample_matrix(na, da_l, a_lo, a_hi_incl, c_base, layers * ba),
                f32,
            )
            cmat = dev_tensor(_upsample_matrix(nc, dc_l, 0, nc - 1, 0, dc_l), f32)
            bmat = dev_tensor(_upsample_matrix(nb, db_l, 0, nb - 1, 0, db_l), f32)

            def up(x):
                x = torch.matmul(amat, x.reshape(layers * ba, dc_l * db_l))
                x = torch.matmul(cmat, x.reshape(-1, dc_l, db_l))
                return torch.matmul(x, bmat.T)

            v_up = up(grid)
            c_up = up(cov)

        # Ownership at render-level granularity: slice row i belongs to
        # tile layer (a_lo+i)//(ba·f) − l_lo.
        rows = torch.arange(a_lo, a_lo + s_count, device=dev)
        own = own_tiles[rows // (f * ba) - l_lo]  # (S, tc, tb)
        own = own.repeat_interleave(f * bc, dim=1)[:, :nc]
        own = own.repeat_interleave(f * bb, dim=2)[:, :, :nb]
        num = v_up * own if num is None else num + v_up * own
        den = c_up * own if den is None else den + c_up * own

    covered = den > 0.01
    dens = torch.where(covered, num / torch.clamp(den, min=1e-6), 0.0)
    dens = torch.clamp((dens - plan.lo) / (plan.hi - plan.lo), 0.0, 1.0)
    return torch.where(covered, dens, SENTINEL).contiguous()


def store_content(store: torch.Tensor) -> torch.Tensor:
    """(Na,) int32 per-slice coverage flags for exact empty-space
    skipping: a plane whose bracketing slices are both fully uncovered
    interpolates to SENTINEL everywhere, masks to zero alpha, and its
    composite step is the identity."""
    return (store > -0.5).flatten(1).any(dim=1).to(torch.int32)


# ==================================================================== sweep
@dataclasses.dataclass(frozen=True)
class SweepTables:
    """Per-frame device operands of :func:`post_sweep`."""

    a0: torch.Tensor  # (K,) i32 slice index below each plane
    a1: torch.Tensor  # (K,) i32 slice index above (clamped at the edge)
    wa: torch.Tensor  # (K,) f32 axis lerp weight
    dl: torch.Tensor  # (K,) f32 plane z − eye_a
    act: torch.Tensor  # (K,) i32 1 = plane may sample covered voxels
    view: torch.Tensor  # (8,) f32 [u0, du, dv, eb, ec, v0, eye_a, 0]
    corr: torch.Tensor  # (V, U) f32 opacity-correction exponent
    rgb_in: torch.Tensor  # (V, U, 4) f32 carry-in (channel 3 ignored)
    t_in: torch.Tensor  # (V, U) f32 carry-in transmittance


def sweep_tables(
    fv: torch.Tensor,
    *,
    na: int,
    k_planes: int,
    v_size: int,
    u_size: int,
    content: Optional[torch.Tensor] = None,
) -> SweepTables:
    """Derive the sweep's per-frame tables on ``fv``'s device from the
    view vector ``fv[:11]`` = [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0,
    sign, max_samples_per_ray], in f32 as the frame runs them: global
    front-to-back plane tables (as :func:`plane_tables`), plane activity
    from the store's slice coverage, the per-ray opacity-correction
    exponent ``msr·dz·√(1+u²+v²)``, and the initial carry."""
    dev = fv.device
    f32 = torch.float32
    wa0, wa1, eye_a = fv[0], fv[1], fv[2]
    u0, du, dv = fv[3], fv[4], fv[5]
    eb, ec, v0, sign, msr = fv[6], fv[7], fv[8], fv[9], fv[10]
    k = torch.arange(k_planes, dtype=f32, device=dev)
    dz = (wa1 - wa0) / k_planes
    z = torch.where(sign > 0, wa0 + (k + 0.5) * dz, wa1 - (k + 0.5) * dz)
    sa = torch.clamp((z - wa0) / (wa1 - wa0) * na - 0.5, -0.5, na - 0.5)
    i0 = torch.floor(torch.clamp(sa, 0.0, float(na - 1)))
    wa = torch.clamp(sa - i0, 0.0, 1.0)
    a0 = i0.to(torch.int32)
    a1 = torch.clamp(i0 + 1.0, max=float(na - 1)).to(torch.int32)
    if content is not None:
        act = content[a0.long()] | content[a1.long()]
    else:
        act = torch.ones(k_planes, dtype=torch.int32, device=dev)
    view = torch.stack([u0, du, dv, eb, ec, v0, eye_a, torch.zeros_like(u0)])
    ug = u0 + du * torch.arange(u_size, dtype=f32, device=dev)
    vg = v0 + dv * torch.arange(v_size, dtype=f32, device=dev)
    length = torch.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
    return SweepTables(
        a0=a0,
        a1=a1,
        wa=wa,
        dl=z - eye_a,
        act=act,
        view=view,
        corr=msr * dz * length,
        rgb_in=torch.zeros((v_size, u_size, 4), dtype=f32, device=dev),
        t_in=torch.ones((v_size, u_size), dtype=f32, device=dev),
    )


def _taps(s: torch.Tensor, n: int):
    """Two-tap linear interpolation indices and weight at fractional
    voxel coordinate ``s`` with clamp-to-edge: the rows and weights of
    the reference's interpolation matrices (``_interp_matrix``)."""
    s = torch.clamp(s, -0.5, n - 0.5)
    i0f = torch.floor(torch.clamp(s, 0.0, float(n - 1)))
    w = torch.clamp(s - i0f, 0.0, 1.0)
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), w


def post_sweep_reference(
    store: torch.Tensor,
    tf: torch.Tensor,
    tables: SweepTables,
    clip: torch.Tensor,
    *,
    n_clip: int,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
    samples: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch sweep: the specification of ``csrc/post_sweep.cu``.

    Vectorized over the (V, U) slope rays with a Python loop over the K
    planes.  Per plane k and ray (v, u), with ug = u0 + du·u and
    vg = v0 + dv·v:

    * sample point xb = eb + ug·dl[k], xc = ec + vg·dl[k];
    * density: lerp slices a0[k], a1[k] by wa[k] at each of the 2×2
      in-plane taps, then lerp along b, then along c;
    * mask: inside the b/c box × covered (density > −0.5, i.e. no
      SENTINEL voxel pulled it down) × the n_clip half-spaces
      ``n_a·z + n_b·xb + n_c·xc + d ≥ 0`` × act[k];
    * classify: linear 256-entry TF lookup of the clamped density;
    * opacity correction ``1 − (1 − min(a, 1 − 1/256))^corr``;
    * composite front to back while ``1 − t ≤ early_exit``.

    Returns (rgb + alpha (V, U, 4), transmittance (V, U)); the carry
    enters through ``tables.rgb_in`` / ``tables.t_in``.  ``samples``, a
    (V, U) int64 tensor if given, is incremented by the planes at which
    each ray fetches the store (not yet saturated, plane active, inside
    the box and the clip half-spaces): the kernel's work per ray.
    """
    f32 = torch.float32
    dev = store.device
    _na, nc, nb = store.shape
    v_size, u_size = tables.corr.shape
    wb0, wb1 = wb
    wc0, wc1 = wc
    sb_scale = nb / (wb1 - wb0)
    sc_scale = nc / (wc1 - wc0)
    u0, du, dv, eb, ec, v0, eye_a = tables.view[:7]
    ug = u0 + du * torch.arange(u_size, dtype=f32, device=dev)
    vg = v0 + dv * torch.arange(v_size, dtype=f32, device=dev)
    flat = store.reshape(-1)
    plane = nc * nb

    rgb = tables.rgb_in[..., :3].clone()
    t = tables.t_in.clone()
    for k in range(tables.a0.shape[0]):
        wa = tables.wa[k]
        delta = tables.dl[k]
        xb = eb + ug * delta  # (U,)
        xc = ec + vg * delta  # (V,)
        ib0, ib1, w_b = _taps((xb - wb0) * sb_scale - 0.5, nb)
        ic0, ic1, w_c = _taps((xc - wc0) * sc_scale - 0.5, nc)
        lo = tables.a0[k].long() * plane
        hi = tables.a1[k].long() * plane

        def tap(ic, ib):
            o = ic[:, None] * nb + ib[None, :]
            return flat[lo + o] * (1.0 - wa) + flat[hi + o] * wa

        s_c0 = tap(ic0, ib0) * (1.0 - w_b) + tap(ic0, ib1) * w_b
        s_c1 = tap(ic1, ib0) * (1.0 - w_b) + tap(ic1, ib1) * w_b
        dens = s_c0 * (1.0 - w_c)[:, None] + s_c1 * w_c[:, None]

        inside_u = (xb >= wb0) & (xb < wb1)
        inside_v = (xc >= wc0) & (xc < wc1)
        fetch = inside_v[:, None] & inside_u[None, :] & (tables.act[k] != 0)
        z = delta + eye_a
        for p in range(n_clip):
            expr = (
                clip[p, 0] * z + clip[p, 1] * xb[None, :]
                + clip[p, 2] * xc[:, None] + clip[p, 3]
            )
            fetch = fetch & (expr >= 0.0)
        mask = fetch & (dens > -0.5)

        rgba = lookup(tf, dens)
        alpha = rgba[..., 3] * mask.to(f32)
        a_corr = 1.0 - torch.pow(
            1.0 - torch.clamp(alpha, max=ALPHA_CLAMP), tables.corr
        )
        alive = (1.0 - t) <= early_exit
        if samples is not None:
            samples += fetch & alive
        m = alive.to(f32)
        a_eff = a_corr * m
        rgb = rgb + (a_eff * t)[..., None] * rgba[..., :3]
        t = t * (1.0 - a_eff)
    return torch.cat([rgb, (1.0 - t)[..., None]], dim=-1), t


def _check_sweep_operands(store, tf, tables: SweepTables, what="post_sweep", **extra):
    """Reject what the CUDA kernel ``what`` does not take, before any
    pointer reaches it: the store, the TF and the tables, plus ``extra``
    operands given as ``name=(tensor, dtype, shape)``."""
    dev = store.device
    k_planes = tables.a0.shape[0]
    v_size, u_size = tables.corr.shape
    expect = {
        "store": (store, torch.float32, None),
        "tf": (tf, torch.float32, (TF_SIZE, 4)),
        "a0": (tables.a0, torch.int32, (k_planes,)),
        "a1": (tables.a1, torch.int32, (k_planes,)),
        "wa": (tables.wa, torch.float32, (k_planes,)),
        "dl": (tables.dl, torch.float32, (k_planes,)),
        "act": (tables.act, torch.int32, (k_planes,)),
        "view": (tables.view, torch.float32, (8,)),
        "corr": (tables.corr, torch.float32, (v_size, u_size)),
        "rgb_in": (tables.rgb_in, torch.float32, (v_size, u_size, 4)),
        "t_in": (tables.t_in, torch.float32, (v_size, u_size)),
        **extra,
    }
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, store on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, needs {dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if store.dim() != 3 or min(store.shape) < 1:
        raise ValueError(f"{what}: store shape {tuple(store.shape)}")
    if k_planes < 1 or v_size < 1 or u_size < 1:
        raise ValueError(f"{what}: empty plane or ray grid")
    if tf.data_ptr() % 16:
        raise ValueError(f"{what}: tf must be 16-byte aligned")


def post_sweep(
    store: torch.Tensor,
    tf: torch.Tensor,
    tables: SweepTables,
    clip: torch.Tensor,
    *,
    n_clip: int,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep: launches ``csrc/post_sweep.cu`` for CUDA tensors and
    runs :func:`post_sweep_reference` for CPU tensors (same signature and
    result).  ``post_sweep.launches`` counts kernel launches."""
    _check_sweep_operands(
        store, tf, tables, clip=(clip, torch.float32, (MAX_CLIP_PLANES, 4))
    )
    if not 0 <= n_clip <= MAX_CLIP_PLANES:
        raise ValueError(f"post_sweep: n_clip={n_clip} outside [0, 8]")
    if store.device.type == "cpu":
        return post_sweep_reference(
            store, tf, tables, clip, n_clip=n_clip, wb=wb, wc=wc,
            early_exit=early_exit,
        )
    if store.device.type != "cuda":
        raise ValueError(f"post_sweep: no kernel for device {store.device}")
    _na, nc, nb = store.shape
    v_size, u_size = tables.corr.shape
    out = torch.empty((v_size, u_size, 4), dtype=torch.float32, device=store.device)
    t_out = torch.empty((v_size, u_size), dtype=torch.float32, device=store.device)
    with torch.cuda.device(store.device):
        _kernels.launch(
            "post_sweep",
            store, tf, tables.a0, tables.a1, tables.wa, tables.dl, tables.act,
            tables.view, tables.corr, clip, tables.rgb_in, tables.t_in,
            out, t_out,
            tables.a0.shape[0], nc, nb, v_size, u_size, n_clip,
            wb[0], wb[1], wc[0], wc[1], nb / (wb[1] - wb[0]),
            nc / (wc[1] - wc[0]), early_exit,
        )
    post_sweep.launches += 1
    return out, t_out


post_sweep.launches = 0


# =================================================== steady-state frames
class StoreFrameRunner:
    """Steady-state frame from a cached assembled store.

    Holds everything camera-independent (clip rows, statics, coverage
    flags); per frame only the 43-float view vector crosses host →
    device, and the sweep tables, the sweep and the warp run on the
    store's device."""

    def __init__(
        self, store, plan, *, params: RenderParams, swp: sw.ShearWarpParams,
        world_min, world_max, clip_planes_world=None, content=None,
        viewport=None,
    ):
        wmin = np.asarray(world_min, np.float32)
        wmax = np.asarray(world_max, np.float32)
        self.device = store.device
        self.axis = plan.axis
        self.b_axis, self.c_axis = sw._BC_AXES[self.axis]
        self.na = plan.fine_dims[0]
        clip_m, self.n_clip = clip_matrix(clip_planes_world, self.axis)
        self.clip = torch.from_numpy(clip_m).to(self.device)
        self.v_size, self.u_size = swp.inter_size
        self.k_planes = swp.n_planes
        self.wmin, self.wmax = wmin, wmax
        self.wb = (float(wmin[self.b_axis]), float(wmax[self.b_axis]))
        self.wc = (float(wmin[self.c_axis]), float(wmax[self.c_axis]))
        self.early_exit = float(params.early_exit)
        self.max_spr = float(params.max_samples_per_ray)
        self.slope_margin = swp.slope_margin
        self.content = content
        self.viewport = (
            tuple(int(x) for x in viewport) if viewport is not None else None
        )

    def view_vector(self, camera, sw_plan) -> np.ndarray:
        """(43,) f32: [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign,
        msr | inv_proj (16) | inv_mv (16)]."""
        eye = np.asarray(sw_plan.eye, np.float32)
        u0, u1, v0, v1 = sw_plan.bounds
        fv = np.empty(43, np.float32)
        fv[:11] = [
            self.wmin[self.axis], self.wmax[self.axis], eye[self.axis],
            u0, (u1 - u0) / (self.u_size - 1),
            (v1 - v0) / (self.v_size - 1),
            eye[self.b_axis], eye[self.c_axis], v0, sw_plan.sign,
            self.max_spr,
        ]
        fv[11:27] = np.asarray(camera.inv_proj, np.float32).ravel()
        fv[27:43] = np.asarray(camera.inv_mv, np.float32).ravel()
        return fv

    def __call__(self, store, tf, camera, sw_plan=None) -> torch.Tensor:
        if sw_plan is None:
            sw_plan = sw.make_view_plan(camera, self.slope_margin)
        if sw_plan.axis != self.axis:
            raise ValueError(
                f"view major axis {sw_plan.axis} != store axis {self.axis}"
            )
        fv = torch.from_numpy(self.view_vector(camera, sw_plan)).to(self.device)
        tables = sweep_tables(
            fv, na=self.na, k_planes=self.k_planes, v_size=self.v_size,
            u_size=self.u_size, content=self.content,
        )
        inter, _t = post_sweep(
            store, tf, tables, self.clip, n_clip=self.n_clip, wb=self.wb,
            wc=self.wc, early_exit=self.early_exit,
        )
        if self.viewport is None:
            return inter
        return sw.warp_frame_device(
            inter, fv[11:27].reshape(4, 4), fv[27:43].reshape(4, 4),
            fv[3], fv[4], fv[5], fv[8], fv[9],
            axis=self.axis, viewport=self.viewport,
        )


def render_store_frame(
    store: torch.Tensor,  # (Na, Nc, Nb) from assemble_store
    plan: AssemblyPlan,
    tf: torch.Tensor,  # (256, 4) on the store's device
    camera,
    *,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    world_min,
    world_max,
    sw_plan: Optional[sw.ViewPlan] = None,
    clip_planes_world: Optional[np.ndarray] = None,
    content: Optional[torch.Tensor] = None,
    to_screen: bool = True,
) -> torch.Tensor:
    """Camera → (H, W, 4) screen image, or the (V, U, 4) slope grid with
    ``to_screen=False``, from an assembled store.  One-shot form of
    :class:`StoreFrameRunner`."""
    runner = StoreFrameRunner(
        store, plan, params=params, swp=swp, world_min=world_min,
        world_max=world_max, clip_planes_world=clip_planes_world,
        content=content, viewport=camera.viewport if to_screen else None,
    )
    return runner(store, tf, camera, sw_plan)
