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

Out of core, a frame is swept in A-slab passes (:func:`make_slab_plans`,
:class:`SlabSweep`): each pass assembles only its slices and sweeps its
planes of the global tables onto the carry of the previous pass, which
composes bit for bit to one sweep (:func:`render_bricked_slope_grid`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
class SlabPlan:
    """One A-slab pass: the store slices it assembles and its planes."""

    a_lo: int  # first render-level slice assembled for this pass
    a_hi_incl: int  # last slice assembled (includes the +1 lerp boundary)
    k_lo: int  # first global plane index of this pass
    k_hi: int  # one past the last plane


def make_slab_plans(a0: np.ndarray, na: int, max_slices: int) -> List[SlabPlan]:
    """Partition the march into A-slab passes of ≤ ``max_slices``
    assembled slices each, covering every plane once in march order.
    ``a0`` holds the global front-to-back plane tables' lower slice
    indices.  Consecutive planes share slices, so slab boundaries repeat
    one slice; its assembled values are the same both times, which keeps
    the passes' composite bit-equal to one sweep."""
    k_total = len(a0)
    if na <= max_slices:
        return [SlabPlan(0, na - 1, 0, k_total)]
    plans: List[SlabPlan] = []
    k = 0
    width = max(2, max_slices)
    while k < k_total:
        lo = int(a0[k])
        if int(a0[k_total - 1]) >= lo:  # marching toward +A
            s_lo, s_hi = lo, min(lo + width - 1, na - 1)
        else:  # marching toward −A: a0 decreasing
            s_hi, s_lo = min(lo + 1, na - 1), max(0, lo + 1 - (width - 1))
        tail = a0[k:]
        need_hi = np.minimum(tail + 1, na - 1)
        in_slab = (tail >= s_lo) & (need_hi <= s_hi)
        run = int(np.argmin(in_slab)) if not in_slab.all() else len(in_slab)
        run = max(run, 1)
        plans.append(SlabPlan(s_lo, s_hi, k, k + run))
        k += run
    return plans


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


def view_vector(
    *,
    world_min,
    world_max,
    axis: int,
    eye,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    inter_size: Tuple[int, int],
    max_samples_per_ray: float,
) -> np.ndarray:
    """(11,) f32 [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign, msr]: the
    view vector :func:`sweep_tables` derives a frame's tables from."""
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = sw._BC_AXES[axis]
    eye = np.asarray(eye, np.float32)
    u0, u1, v0, v1 = slope_bounds
    v_size, u_size = inter_size
    return np.float32([
        wmin[axis], wmax[axis], eye[axis],
        u0, (u1 - u0) / (u_size - 1), (v1 - v0) / (v_size - 1),
        eye[b_axis], eye[c_axis], v0, sign,
        max_samples_per_ray,
    ])


def frame_vector(vs: np.ndarray, camera) -> np.ndarray:
    """(43,) f32: the view vector ``vs`` | inv_proj (16) | inv_mv (16), all
    a frame moves host → device (:func:`warp_frame` reads the rest)."""
    return np.concatenate([
        np.asarray(vs, np.float32),
        np.asarray(camera.inv_proj, np.float32).ravel(),
        np.asarray(camera.inv_mv, np.float32).ravel(),
    ])


def warp_frame(inter: torch.Tensor, fv: torch.Tensor, *, axis: int, viewport) -> torch.Tensor:
    """Slope grid (V, U, 4) → (H, W, 4) screen image, with the slope grid
    and the camera read from the device frame vector ``fv``
    (:func:`frame_vector`)."""
    return sw.warp_frame_device(
        inter, fv[11:27].reshape(4, 4), fv[27:43].reshape(4, 4),
        fv[3], fv[4], fv[5], fv[8], fv[9],
        axis=axis, viewport=tuple(int(x) for x in viewport),
    )


def sweep_tables(
    fv: torch.Tensor,
    *,
    na: int,
    k_planes: int,
    v_size: int,
    u_size: int,
    content: Optional[torch.Tensor] = None,
    slab: Optional[Tuple[torch.Tensor, torch.Tensor, int, int]] = None,
) -> SweepTables:
    """Derive the sweep's per-frame tables on ``fv``'s device from the
    view vector ``fv[:11]`` = [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0,
    sign, max_samples_per_ray], in f32 as the frame runs them: global
    front-to-back plane tables (as :func:`plane_tables`), plane activity
    from the store's slice coverage, the per-ray opacity-correction
    exponent ``msr·dz·√(1+u²+v²)``, and the initial carry.

    ``slab`` = (k0, a_base, k_total, na_store), the slab mode of the
    sharded store trainer: the planes are [k0, k0 + k_planes) of a
    global grid of ``k_total``, read from a store slab of ``na_store``
    slices whose slice 0 is global slice ``a_base``.  Plane positions and
    the edge clamp are computed on the global grid first (the same
    floats as the global tables), then shifted into the slab, clamped.
    ``sweep_tables.builds`` counts calls."""
    sweep_tables.builds += 1
    dev = fv.device
    f32 = torch.float32
    wa0, wa1, eye_a = fv[0], fv[1], fv[2]
    u0, du, dv = fv[3], fv[4], fv[5]
    eb, ec, v0, sign, msr = fv[6], fv[7], fv[8], fv[9], fv[10]
    k = torch.arange(k_planes, dtype=f32, device=dev)
    k_total = k_planes
    if slab is not None:
        k0, a_base, k_total, na_store = slab
        k = k0 + k
    dz = (wa1 - wa0) / k_total
    z = torch.where(sign > 0, wa0 + (k + 0.5) * dz, wa1 - (k + 0.5) * dz)
    sa = torch.clamp((z - wa0) / (wa1 - wa0) * na - 0.5, -0.5, na - 0.5)
    i0 = torch.floor(torch.clamp(sa, 0.0, float(na - 1)))
    wa = torch.clamp(sa - i0, 0.0, 1.0)
    i1 = torch.clamp(i0 + 1.0, max=float(na - 1))
    if slab is not None:
        i0 = torch.clamp(i0 - a_base, 0.0, float(na_store - 1))
        i1 = torch.clamp(i1 - a_base, 0.0, float(na_store - 1))
    a0 = i0.to(torch.int32)
    a1 = i1.to(torch.int32)
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


sweep_tables.builds = 0


def _taps(s: torch.Tensor, n: int):
    """Two-tap linear interpolation indices and weight at fractional
    voxel coordinate ``s`` with clamp-to-edge: the rows and weights of
    the reference's interpolation matrices (``_interp_matrix``)."""
    s = torch.clamp(s, -0.5, n - 0.5)
    i0f = torch.floor(torch.clamp(s, 0.0, float(n - 1)))
    w = torch.clamp(s - i0f, 0.0, 1.0)
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), w


def mark_taps(touched, lo, hi, ic0, ic1, ib0, ib1, nb: int, rays: torch.Tensor) -> None:
    """Set the flat texel mask ``touched`` at the 2×2 in-plane taps
    (rows ``ic*`` (V,), columns ``ib*`` (U,)) of both slices, at flat
    offsets ``lo`` and ``hi``, for the (V, U) ``rays`` that sample: the
    texels a sweep kernel reads at one plane."""
    for ic in (ic0, ic1):
        for ib in (ib0, ib1):
            o = (ic[:, None] * nb + ib[None, :])[rays]
            touched[lo + o] = True
            touched[hi + o] = True


# The tile of slope rays of K1 and K5, (rows along v, columns along u):
# one CTA each.
SWEEP_TILE = (4, 32)


def tile_to_rays(mask: torch.Tensor, v_size: int, u_size: int) -> torch.Tensor:
    """A (TV, TU) mask over ``SWEEP_TILE`` tiles → the (V, U) mask of
    their rays."""
    rows, cols = SWEEP_TILE
    dev = mask.device
    return mask[torch.arange(v_size, device=dev) // rows][:, torch.arange(u_size, device=dev) // cols]


def rays_to_tiles(mask: torch.Tensor, tv: int, tu: int) -> torch.Tensor:
    """A (V, U) mask of rays → the (tv, tu) mask of the ``SWEEP_TILE``
    tiles holding any of them."""
    rows, cols = SWEEP_TILE
    v_size, u_size = mask.shape
    hit = torch.zeros((tv * rows, tu * cols), dtype=torch.bool, device=mask.device)
    hit[:v_size, :u_size] = mask
    return hit.reshape(tv, rows, tu, cols).any(dim=3).any(dim=1)


def tile_planes_reference(
    tables: SweepTables,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    tile: Tuple[int, int] = SWEEP_TILE,
) -> torch.Tensor:
    """Plain torch plane lists: the specification of the prologue of K1
    and K5 (``csrc/sweep_list.cuh``).

    → (TV, TU, K) bool: plane k is on the list of the ``tile`` = (rows,
    columns) tile (tv, tu) of slope rays iff ``act[k] != 0`` and the
    window [wb0, wb1) × [wc0, wc1) overlaps the tile's sample points
    xb = eb + ug·dl[k], xc = ec + vg·dl[k], bounded by its first and last
    rays (each is monotone in u or v in f32, rounding included).  A
    superset of the planes any ray of the tile fetches at: the per-ray
    window, clip, SENTINEL and early-exit tests are the sweeps'.
    """
    rows, cols = tile
    v_size, u_size = tables.corr.shape
    u0, du, dv, eb, ec, v0 = tables.view[:6]

    def first_last(n, size):  # (tiles, 2) first and last ray index of each tile
        first = torch.arange(0, n, size, device=tables.corr.device)
        return torch.stack([first, torch.clamp(first + size - 1, max=n - 1)], dim=-1)

    ug = u0 + du * first_last(u_size, cols).to(torch.float32)  # (TU, 2)
    vg = v0 + dv * first_last(v_size, rows).to(torch.float32)  # (TV, 2)
    xb = eb + ug[:, :, None] * tables.dl  # (TU, 2, K)
    xc = ec + vg[:, :, None] * tables.dl  # (TV, 2, K)
    xb_lo, xb_hi = xb.amin(dim=1), xb.amax(dim=1)
    xc_lo, xc_hi = xc.amin(dim=1), xc.amax(dim=1)
    in_b = (xb_hi >= wb[0]) & (xb_lo < wb[1])
    in_c = (xc_hi >= wc[0]) & (xc_lo < wc[1])
    return in_c[:, None, :] & in_b[None, :, :] & (tables.act != 0)


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
    planes: Optional[torch.Tensor] = None,
    touched: Optional[torch.Tensor] = None,
    only: Optional[torch.Tensor] = None,
    fetches: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch sweep: the specification of ``csrc/post_sweep.cu``.

    Vectorized over the (V, U) slope rays with a Python loop over the K
    planes.  Per plane k and ray (v, u), with ug = u0 + du·u and
    vg = v0 + dv·v:

    * sample point xb = eb + ug·dl[k], xc = ec + vg·dl[k];
    * density: lerp slices a0[k], a1[k] by wa[k] at each of the 2×2
      in-plane taps, then lerp along b, then along c; with
      ``compute_dtype="bfloat16"`` (K1's kBf16 instance) each of the two
      resample stages rounds its operands to bf16 (the axis-lerped taps and
      the b weights; the b-lerped rows and the c weights,
      ``shearwarp.tap_weights``) and sums in f32, as the JAX kernel's two
      products;
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
    ``planes``, a (K,) bool tensor if given, is set where any ray fetches.
    ``touched``, a bool tensor of the store's shape if given, is set at
    every voxel the kernel reads: the 2×2 taps of both slices of each
    fetched sample.  ``only``, a (TV, TU, K) bool tensor of plane lists
    per ``SWEEP_TILE`` tile if given (:func:`tile_planes_reference`),
    restricts each ray to its tile's listed planes, as K1 walks them.
    ``fetches``, a (TV, TU, K) bool tensor if given, is set where some ray
    of the tile fetches at the plane.
    """
    f32 = torch.float32
    dev = store.device
    rnd = sw.resample_rounding(compute_dtype)
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
            return rnd(flat[lo + o] * (1.0 - wa) + flat[hi + o] * wa)

        # The b and c weights as the JAX kernel's interpolation matrices hold them.
        mb0, mb1 = sw.tap_weights(ib0, ib1, w_b, compute_dtype)
        mc0, mc1 = sw.tap_weights(ic0, ic1, w_c, compute_dtype)
        s_c0 = rnd(tap(ic0, ib0) * mb0 + tap(ic0, ib1) * mb1)
        s_c1 = rnd(tap(ic1, ib0) * mb0 + tap(ic1, ib1) * mb1)
        dens = s_c0 * mc0[:, None] + s_c1 * mc1[:, None]

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
        if only is not None:
            fetch = fetch & tile_to_rays(only[..., k], v_size, u_size)
        mask = fetch & (dens > -0.5)

        rgba = lookup(tf, dens)
        alpha = rgba[..., 3] * mask.to(f32)
        a_corr = 1.0 - torch.pow(
            1.0 - torch.clamp(alpha, max=ALPHA_CLAMP), tables.corr
        )
        alive = (1.0 - t) <= early_exit
        if samples is not None:
            samples += fetch & alive
        if planes is not None:
            planes[k] = (fetch & alive).any()
        if fetches is not None:
            fetches[..., k] = rays_to_tiles(fetch & alive, *fetches.shape[:2])
        if touched is not None:
            mark_taps(touched.view(-1), lo, hi, ic0, ic1, ib0, ib1, nb, fetch & alive)
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
    check_operands(what, dev, expect)
    if store.dim() != 3 or min(store.shape) < 1:
        raise ValueError(f"{what}: store shape {tuple(store.shape)}")
    if k_planes < 1 or v_size < 1 or u_size < 1:
        raise ValueError(f"{what}: empty plane or ray grid")
    if tf.data_ptr() % 16:
        raise ValueError(f"{what}: tf must be 16-byte aligned")


def check_operands(what: str, dev: torch.device, expect) -> None:
    """Raise unless every operand of ``expect``, ``name=(tensor, dtype,
    shape or None)``, lies contiguous on ``dev`` with that dtype and
    shape."""
    for name, (x, dtype, shape) in expect.items():
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, operands on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, needs {dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


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
    compute_dtype: str = "float32",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep: launches ``csrc/post_sweep.cu`` for CUDA tensors (its
    bf16-resample instance for ``compute_dtype="bfloat16"``) and runs
    :func:`post_sweep_reference` for CPU tensors (same signature and
    result).  ``post_sweep.launches`` counts kernel launches."""
    _check_sweep_operands(
        store, tf, tables, clip=(clip, torch.float32, (MAX_CLIP_PLANES, 4))
    )
    if not 0 <= n_clip <= MAX_CLIP_PLANES:
        raise ValueError(f"post_sweep: n_clip={n_clip} outside [0, 8]")
    if compute_dtype not in sw.COMPUTE_DTYPES:
        raise ValueError(f"post_sweep: compute_dtype {compute_dtype!r}")
    if store.device.type == "cpu":
        return post_sweep_reference(
            store, tf, tables, clip, n_clip=n_clip, wb=wb, wc=wc,
            early_exit=early_exit, compute_dtype=compute_dtype,
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
            nc / (wc[1] - wc[0]), early_exit, int(compute_dtype == "bfloat16"),
        )
    post_sweep.launches += 1
    return out, t_out


post_sweep.launches = 0


# =================================================== frames and slab passes
class SlabSweep:
    """One view's sweep of K1 over an assembled store, whole or in A-slab
    passes (``libre_tpu.ops.shearwarp_bricked.SlabSweep``).

    Holds everything camera-independent (clip rows, box, statics).  The
    frame's global plane tables come from the view vector on the device
    (:meth:`tables`); :meth:`run_pass` sweeps one slab's planes with the
    (rgb, transmittance) of the previous pass as its carry, the
    multipass accumulation of GLRaycastPipeline.cpp:148-186.  The plane
    grid is global, so the passes compose bit for bit to one sweep."""

    def __init__(
        self, *, device, axis: int, na: int, params: RenderParams,
        swp: sw.ShearWarpParams, world_min, world_max,
        clip_planes_world=None, viewport=None,
    ):
        wmin = np.asarray(world_min, np.float32)
        wmax = np.asarray(world_max, np.float32)
        self.device = torch.device(device)
        self.axis = axis
        self.b_axis, self.c_axis = sw._BC_AXES[axis]
        self.na = na
        clip_m, self.n_clip = clip_matrix(clip_planes_world, axis)
        self.clip = torch.from_numpy(clip_m).to(self.device)
        self.v_size, self.u_size = swp.inter_size
        self.k_planes = swp.n_planes
        self.wmin, self.wmax = wmin, wmax
        self.wb = (float(wmin[self.b_axis]), float(wmax[self.b_axis]))
        self.wc = (float(wmin[self.c_axis]), float(wmax[self.c_axis]))
        self.early_exit = float(params.early_exit)
        self.max_spr = float(params.max_samples_per_ray)
        self.slope_margin = swp.slope_margin
        self.compute_dtype = swp.compute_dtype
        self.viewport = (
            tuple(int(x) for x in viewport) if viewport is not None else None
        )

    def view(self, eye, sign: float, slope_bounds) -> np.ndarray:
        """(11,) f32 :func:`view_vector` of this view."""
        return view_vector(
            world_min=self.wmin, world_max=self.wmax, axis=self.axis,
            eye=eye, sign=sign, slope_bounds=slope_bounds,
            inter_size=(self.v_size, self.u_size), max_samples_per_ray=self.max_spr,
        )

    def view_vector(self, camera, sw_plan) -> np.ndarray:
        """(43,) f32 :func:`frame_vector` of this view."""
        return frame_vector(self.view(sw_plan.eye, sw_plan.sign, sw_plan.bounds), camera)

    def tables(self, fv: torch.Tensor, content: Optional[torch.Tensor] = None) -> SweepTables:
        """The frame's global :func:`sweep_tables` from the view vector on
        the device, with the initial carry."""
        return sweep_tables(
            fv, na=self.na, k_planes=self.k_planes, v_size=self.v_size,
            u_size=self.u_size, content=content,
        )

    def sweep(self, store, tf, tables: SweepTables) -> Tuple[torch.Tensor, torch.Tensor]:
        """K1 (:func:`post_sweep`) over ``store`` with these tables, in the
        resample type of the view's ``ShearWarpParams``."""
        return post_sweep(
            store, tf, tables, self.clip, n_clip=self.n_clip, wb=self.wb,
            wc=self.wc, early_exit=self.early_exit, compute_dtype=self.compute_dtype,
        )

    def run_pass(self, slab, tf, tables: SweepTables, sp: SlabPlan, carry):
        """Sweep planes [sp.k_lo, sp.k_hi) of the global ``tables`` over
        ``slab``, the assembled slices [sp.a_lo, sp.a_hi_incl], onto the
        ``carry`` (rgb + alpha (V, U, 4), transmittance (V, U)) → the next
        carry.  Plane activity comes from the slab's own coverage."""
        kr = slice(sp.k_lo, sp.k_hi)
        a0 = (tables.a0[kr] - sp.a_lo).contiguous()
        a1 = (tables.a1[kr] - sp.a_lo).contiguous()
        content = store_content(slab)
        return self.sweep(slab, tf, dataclasses.replace(
            tables, a0=a0, a1=a1, wa=tables.wa[kr].contiguous(),
            dl=tables.dl[kr].contiguous(), act=content[a0.long()] | content[a1.long()],
            rgb_in=carry[0], t_in=carry[1],
        ))

    def warp(self, inter: torch.Tensor, fv: torch.Tensor) -> torch.Tensor:
        """The slope grid on screen (:func:`warp_frame`), or the slope grid
        itself without a viewport."""
        if self.viewport is None:
            return inter
        return warp_frame(inter, fv, axis=self.axis, viewport=self.viewport)


class StoreFrameRunner(SlabSweep):
    """Steady-state frame from a cached assembled store: per frame only
    the 43-float view vector crosses host → device, and the sweep tables,
    one sweep and the warp run on the store's device."""

    def __init__(
        self, store, plan, *, params: RenderParams, swp: sw.ShearWarpParams,
        world_min, world_max, clip_planes_world=None, content=None,
        viewport=None,
    ):
        super().__init__(
            device=store.device, axis=plan.axis, na=plan.fine_dims[0],
            params=params, swp=swp, world_min=world_min, world_max=world_max,
            clip_planes_world=clip_planes_world, viewport=viewport,
        )
        self.content = content

    def __call__(self, store, tf, camera, sw_plan=None) -> torch.Tensor:
        if sw_plan is None:
            sw_plan = sw.make_view_plan(camera, self.slope_margin)
        if sw_plan.axis != self.axis:
            raise ValueError(
                f"view major axis {sw_plan.axis} != store axis {self.axis}"
            )
        fv = torch.from_numpy(self.view_vector(camera, sw_plan)).to(self.device)
        inter, _t = self.sweep(store, tf, self.tables(fv, self.content))
        return self.warp(inter, fv)


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


def render_bricked_slope_grid(
    atlas_data: torch.Tensor,
    plan: AssemblyPlan,
    tf: torch.Tensor,  # (256, 4) on the atlas's device
    *,
    eye,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    clip_planes_world: Optional[np.ndarray] = None,
    max_slab_slices: Optional[int] = None,
    store: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Slope-space frame of the rendering set → (V, U, 4).

    Assembles the density store in A-slab passes of ≤ ``max_slab_slices``
    slices each and sweeps K1 over each with the carry threaded through,
    the memory-bounded multipass of GLRaycastPipeline.cpp:148-186.  A
    prebuilt whole ``store`` (:func:`assemble_store`) is swept in one
    pass."""
    na = plan.fine_dims[0]
    sweep = SlabSweep(
        device=atlas_data.device, axis=plan.axis, na=na, params=params,
        swp=swp, world_min=world_min, world_max=world_max,
        clip_planes_world=clip_planes_world,
    )
    fv = torch.from_numpy(sweep.view(eye, sign, slope_bounds)).to(sweep.device)
    tables = sweep.tables(fv)
    if store is not None or max_slab_slices is None or na <= max_slab_slices:
        plans = [SlabPlan(0, na - 1, 0, swp.n_planes)]
    else:
        plans = make_slab_plans(tables.a0.cpu().numpy(), na, max_slab_slices)
    carry = (tables.rgb_in, tables.t_in)
    for sp in plans:
        slab = store if store is not None else assemble_store(
            atlas_data, plan, sp.a_lo, sp.a_hi_incl
        )
        carry = sweep.run_pass(slab, tf, tables, sp, carry)
    return carry[0]
