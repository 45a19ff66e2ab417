"""Dense pre-classified shear-warp on the card
(``libre_tpu.ops.shearwarp_pallas``): the wrapper of K5
(``csrc/pre_sweep.cu``) and the frame functions around it.

A dense volume is classified once per (volume, TF, major axis) into a
stack of RGBA slices (:func:`classify_planes`), with per-slice content
flags (:func:`slice_content`); a frame is then one sweep of that stack
(:func:`pre_sweep`: K5 on a CUDA tensor, its plain version
:func:`pre_sweep_reference` on a CPU tensor) and the screen warp.  The
sweep's per-frame tables derive on the device from one view vector
(``shearwarp_bricked.sweep_tables``, shared with the bricked sweep K1).

:func:`render_slope_grid_fused` is the differentiable form: forward
classify + sweep, backward a recompute through the plain pipeline
``shearwarp.render_slope_grid`` under autograd.

The classified stack is (Na, Nc, Nb, 4) f32, unpadded, so a tap is one
16-byte load; the JAX package's (Na, 4·Nc_pad, Nb_pad) stack converts
with ``interop.classified_from_jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops.reference import ALPHA_CLAMP, Camera, RenderParams
from libre_tpu_torch.ops.transfer_function import lookup

# Voxels classified per step: bounds classify_planes' temporaries (~100
# bytes a voxel) at ~400 MB whatever the volume.
CLASSIFY_CHUNK = 1 << 22


def classify_planes(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    axis: int,
    data_source_range: Tuple[float, float],
    chunk: int = CLASSIFY_CHUNK,
) -> torch.Tensor:
    """The classified, axis-permuted slice stack (Na, Nc, Nb, 4) f32 on
    ``volume_zyx``'s device: the TF's linear lookup of every voxel's
    normalized density, computed a run of slices at a time."""
    lo, hi = data_source_range
    vol = volume_zyx.permute(sw._PERM[axis])
    na, nc, nb = vol.shape
    out = torch.empty((na, nc, nb, 4), dtype=torch.float32, device=vol.device)
    step = max(1, chunk // (nc * nb))
    for a in range(0, na, step):
        dens = (vol[a : a + step].to(torch.float32) - lo) / (hi - lo)
        out[a : a + step] = lookup(tf, dens)
    return out


def slice_content(chans: torch.Tensor) -> torch.Tensor:
    """(Na,) int32: 1 where classified slice ``a`` holds any nonzero
    alpha.  A plane whose two slices hold none lerps to zero alpha and
    composites as the identity, so skipping it is exact."""
    return (chans[..., 3].amax(dim=(1, 2)) > 0.0).to(torch.int32)


# ==================================================================== sweep
def pre_sweep_reference(
    chans: torch.Tensor,
    tables: swb.SweepTables,
    *,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
    samples: Optional[torch.Tensor] = None,
    planes: Optional[torch.Tensor] = None,
    touched: Optional[torch.Tensor] = None,
    only: Optional[torch.Tensor] = None,
    fetches: Optional[torch.Tensor] = None,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Plain torch sweep: the specification of ``csrc/pre_sweep.cu``.

    Vectorized over the (V, U) slope rays with a Python loop over the K
    planes.  Per plane k and ray (v, u), with ug = u0 + du·u and
    vg = v0 + dv·v:

    * sample point xb = eb + ug·dl[k], xc = ec + vg·dl[k];
    * RGBA, per channel: lerp slices a0[k], a1[k] by wa[k] at each of the
      2×2 in-plane taps, then lerp along b, then along c; with
      ``compute_dtype="bfloat16"`` (K5's kBf16 instance) each resample
      stage rounds its operands to bf16, per channel, and sums in f32, as
      the JAX kernel's products (``shearwarp_pallas.py:281-312``);
    * mask: inside the half-open b/c box × act[k];
    * opacity correction ``1 − (1 − min(a, 1 − 1/256))^corr``;
    * composite front to back from (rgb, t) = (0, 1) while
      ``1 − t ≤ early_exit``.

    Returns (rgb, 1 − t) as (V, U, 4); ``tables.rgb_in`` and ``t_in`` are
    not read.  ``samples``, a (V, U) int64 tensor if given, is incremented
    by the planes at which each ray composites a sample (not yet
    saturated, plane active, inside the box): the kernel's work per ray.
    ``planes``, a (K,) bool tensor if given, is set where any ray does.
    ``touched``, an (Na, Nc, Nb) bool tensor if given, is set at every
    texel the kernel reads: the 2×2 taps of both slices of each sample
    counted in ``samples``.  ``only``, a (TV, TU, K) bool tensor of plane
    lists per ``SWEEP_TILE`` tile if given
    (``shearwarp_bricked.tile_planes_reference``), restricts each ray to
    its tile's listed planes, as K5 walks them; ``fetches``, a (TV, TU, K)
    bool tensor if given, is set where some ray of the tile composites at
    the plane.
    """
    f32 = torch.float32
    dev = chans.device
    rnd = sw.resample_rounding(compute_dtype)
    _na, nc, nb, _ = chans.shape
    v_size, u_size = tables.corr.shape
    wb0, wb1 = wb
    wc0, wc1 = wc
    sb_scale = nb / (wb1 - wb0)
    sc_scale = nc / (wc1 - wc0)
    u0, du, dv, eb, ec, v0 = tables.view[:6]
    ug = u0 + du * torch.arange(u_size, dtype=f32, device=dev)
    vg = v0 + dv * torch.arange(v_size, dtype=f32, device=dev)
    flat = chans.reshape(-1, 4)
    plane = nc * nb

    rgb = torch.zeros((v_size, u_size, 3), dtype=f32, device=dev)
    t = torch.ones((v_size, u_size), dtype=f32, device=dev)
    for k in range(tables.a0.shape[0]):
        wa = tables.wa[k]
        delta = tables.dl[k]
        xb = eb + ug * delta  # (U,)
        xc = ec + vg * delta  # (V,)
        ib0, ib1, w_b = swb._taps((xb - wb0) * sb_scale - 0.5, nb)
        ic0, ic1, w_c = swb._taps((xc - wc0) * sc_scale - 0.5, nc)
        lo = tables.a0[k].long() * plane
        hi = tables.a1[k].long() * plane
        mb0, mb1 = (w[None, :, None] for w in sw.tap_weights(ib0, ib1, w_b, compute_dtype))
        mc0, mc1 = (w[:, None, None] for w in sw.tap_weights(ic0, ic1, w_c, compute_dtype))

        def tap(ic, ib):
            o = ic[:, None] * nb + ib[None, :]
            return rnd(flat[lo + o] * (1.0 - wa) + flat[hi + o] * wa)  # (V, U, 4)

        s_c0 = rnd(tap(ic0, ib0) * mb0 + tap(ic0, ib1) * mb1)
        s_c1 = rnd(tap(ic1, ib0) * mb0 + tap(ic1, ib1) * mb1)
        rgba = s_c0 * mc0 + s_c1 * mc1

        inside_u = (xb >= wb0) & (xb < wb1)
        inside_v = (xc >= wc0) & (xc < wc1)
        fetch = inside_v[:, None] & inside_u[None, :] & (tables.act[k] != 0)
        if only is not None:
            fetch = fetch & swb.tile_to_rays(only[..., k], v_size, u_size)
        alpha = rgba[..., 3] * fetch.to(f32)
        a_corr = 1.0 - torch.pow(
            1.0 - torch.clamp(alpha, max=ALPHA_CLAMP), tables.corr
        )
        alive = (1.0 - t) <= early_exit
        if samples is not None:
            samples += fetch & alive
        if planes is not None:
            planes[k] = (fetch & alive).any()
        if fetches is not None:
            fetches[..., k] = swb.rays_to_tiles(fetch & alive, *fetches.shape[:2])
        if touched is not None:
            swb.mark_taps(touched.view(-1), lo, hi, ic0, ic1, ib0, ib1, nb, fetch & alive)
        a_eff = a_corr * alive.to(f32)
        rgb = rgb + (a_eff * t)[..., None] * rgba[..., :3]
        t = t * (1.0 - a_eff)
    return torch.cat([rgb, (1.0 - t)[..., None]], dim=-1)


def _check_pre_sweep_operands(chans: torch.Tensor, tables: swb.SweepTables) -> None:
    """Reject what K5 does not take, before any pointer reaches it."""
    k_planes = tables.a0.shape[0]
    v_size, u_size = tables.corr.shape
    swb.check_operands("pre_sweep", chans.device, {
        "chans": (chans, torch.float32, None),
        "a0": (tables.a0, torch.int32, (k_planes,)),
        "a1": (tables.a1, torch.int32, (k_planes,)),
        "wa": (tables.wa, torch.float32, (k_planes,)),
        "dl": (tables.dl, torch.float32, (k_planes,)),
        "act": (tables.act, torch.int32, (k_planes,)),
        "view": (tables.view, torch.float32, (8,)),
        "corr": (tables.corr, torch.float32, (v_size, u_size)),
    })
    if chans.dim() != 4 or chans.shape[3] != 4 or min(chans.shape) < 1:
        raise ValueError(f"pre_sweep: chans shape {tuple(chans.shape)} is not (Na, Nc, Nb, 4)")
    if k_planes < 1 or v_size < 1 or u_size < 1:
        raise ValueError("pre_sweep: empty plane or ray grid")
    if chans.data_ptr() % 16:
        raise ValueError("pre_sweep: chans must be 16-byte aligned")


def pre_sweep(
    chans: torch.Tensor,
    tables: swb.SweepTables,
    *,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """The dense sweep → (V, U, 4): launches ``csrc/pre_sweep.cu`` for
    CUDA tensors (its bf16-resample instance for
    ``compute_dtype="bfloat16"``) and runs :func:`pre_sweep_reference` for
    CPU tensors (same signature and result).  ``pre_sweep.launches``
    counts kernel launches."""
    _check_pre_sweep_operands(chans, tables)
    if compute_dtype not in sw.COMPUTE_DTYPES:
        raise ValueError(f"pre_sweep: compute_dtype {compute_dtype!r}")
    if chans.device.type == "cpu":
        return pre_sweep_reference(
            chans, tables, wb=wb, wc=wc, early_exit=early_exit, compute_dtype=compute_dtype
        )
    if chans.device.type != "cuda":
        raise ValueError(f"pre_sweep: no kernel for device {chans.device}")
    _na, nc, nb, _ = chans.shape
    v_size, u_size = tables.corr.shape
    out = torch.empty((v_size, u_size, 4), dtype=torch.float32, device=chans.device)
    with torch.cuda.device(chans.device):
        _kernels.launch(
            "pre_sweep",
            chans, tables.a0, tables.a1, tables.wa, tables.dl, tables.act,
            tables.view, tables.corr, out,
            tables.a0.shape[0], nc, nb, v_size, u_size,
            wb[0], wb[1], wc[0], wc[1], nb / (wb[1] - wb[0]), nc / (wc[1] - wc[0]),
            early_exit, int(compute_dtype == "bfloat16"),
        )
    pre_sweep.launches += 1
    return out


pre_sweep.launches = 0


# ============================================================ view plans
@dataclasses.dataclass(frozen=True)
class SlopeGridPlanArgs:
    """The static view plan of a slope-grid render (the JAX package's
    hashable ``plan_args`` dict)."""

    eye: Tuple[float, float, float]
    axis: int
    sign: float
    slope_bounds: Tuple[float, float, float, float]
    world_min: Tuple[float, float, float]
    world_max: Tuple[float, float, float]
    params: RenderParams
    swp: sw.ShearWarpParams

    def view_vector(self, camera: Optional[Camera] = None) -> np.ndarray:
        """(11,) f32 ``shearwarp_bricked.view_vector`` of this plan, or its
        (43,) ``frame_vector`` with ``camera``."""
        vs = swb.view_vector(
            world_min=self.world_min, world_max=self.world_max, axis=self.axis,
            eye=self.eye, sign=self.sign, slope_bounds=self.slope_bounds,
            inter_size=self.swp.inter_size,
            max_samples_per_ray=self.params.max_samples_per_ray,
        )
        return vs if camera is None else swb.frame_vector(vs, camera)

    def sweep_kwargs(self) -> Dict:
        """The keyword arguments of :func:`pre_sweep` for this plan (the
        resample type its ``swp`` names)."""
        b_axis, c_axis = sw._BC_AXES[self.axis]
        return dict(
            wb=(float(self.world_min[b_axis]), float(self.world_max[b_axis])),
            wc=(float(self.world_min[c_axis]), float(self.world_max[c_axis])),
            early_exit=float(self.params.early_exit),
            compute_dtype=self.swp.compute_dtype,
        )


def slope_grid_plan_args(
    plan, world_min, world_max, params: RenderParams, swp: sw.ShearWarpParams
) -> SlopeGridPlanArgs:
    """``plan``: a ``shearwarp.ShearWarpPlan`` or ``ViewPlan``."""
    return SlopeGridPlanArgs(
        eye=tuple(float(x) for x in np.asarray(plan.eye, np.float32)),
        axis=plan.axis,
        sign=plan.sign,
        slope_bounds=tuple(float(x) for x in plan.bounds),
        world_min=tuple(float(x) for x in np.asarray(world_min, np.float32)),
        world_max=tuple(float(x) for x in np.asarray(world_max, np.float32)),
        params=params,
        swp=swp,
    )


def sweep_operands(
    chans: torch.Tensor,
    plan_args: SlopeGridPlanArgs,
    camera: Optional[Camera] = None,
    content: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, swb.SweepTables]:
    """The frame's view vector on ``chans``' device (with the camera's
    matrices if given) and the sweep tables derived from it."""
    fv = torch.from_numpy(plan_args.view_vector(camera)).to(chans.device)
    v_size, u_size = plan_args.swp.inter_size
    tables = swb.sweep_tables(
        fv, na=chans.shape[0], k_planes=plan_args.swp.n_planes,
        v_size=v_size, u_size=u_size, content=content,
    )
    return fv, tables


def _check_extents(chans: torch.Tensor, nc_real: int, nb_real: int) -> None:
    if tuple(chans.shape[1:3]) != (nc_real, nb_real):
        raise ValueError(
            f"classified stack {tuple(chans.shape)} does not hold "
            f"(Nc, Nb) = ({nc_real}, {nb_real})"
        )


# ======================================================== frame functions
def render_classified_slope_grid(
    chans: torch.Tensor,
    nc_real: int,
    nb_real: int,
    plan_args: SlopeGridPlanArgs,
    content: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Slope-space render (V, U, 4) from a classified stack: the sweep
    alone (inference).  ``content`` (:func:`slice_content`) turns on the
    exact empty-space skipping."""
    _check_extents(chans, nc_real, nb_real)
    _fv, tables = sweep_operands(chans, plan_args, content=content)
    return pre_sweep(chans, tables, **plan_args.sweep_kwargs())


def render_from_classified(
    chans: torch.Tensor,
    *,
    nc_real: int,
    nb_real: int,
    eye,
    axis: int,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: sw.ShearWarpParams,
    content: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`render_classified_slope_grid` with the plan spelled out."""
    plan = sw.ViewPlan(axis=axis, sign=sign, bounds=tuple(slope_bounds), eye=eye)
    pa = slope_grid_plan_args(plan, world_min, world_max, params, swp)
    return render_classified_slope_grid(chans, nc_real, nb_real, pa, content)


def _plain_slope_grid(volume_zyx, tf, pa: SlopeGridPlanArgs) -> torch.Tensor:
    img, _, _ = sw.render_slope_grid(
        volume_zyx, tf, np.asarray(pa.eye, np.float32), pa.axis, pa.sign,
        pa.slope_bounds, pa.world_min, pa.world_max, pa.params, pa.swp,
    )
    return img


class RenderSlopeGridFused(torch.autograd.Function):
    """Forward: classify + the sweep (K5 on a CUDA tensor); backward: the
    plain pipeline recomputed under autograd (the JAX package's
    ``render_slope_grid_pallas`` and its ``_bwd``).  Saves (volume, tf)."""

    @staticmethod
    def forward(ctx, volume_zyx, tf, plan_args: SlopeGridPlanArgs):
        perm = sw._PERM[plan_args.axis]
        shape = volume_zyx.shape
        chans = classify_planes(
            volume_zyx, tf, plan_args.axis, plan_args.params.data_source_range
        )
        out = render_classified_slope_grid(
            chans, shape[perm[1]], shape[perm[2]], plan_args,
            content=slice_content(chans),
        )
        ctx.plan_args = plan_args
        ctx.save_for_backward(volume_zyx, tf)
        return out

    @staticmethod
    def backward(ctx, g):
        volume_zyx, tf = ctx.saved_tensors
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip((volume_zyx, tf), ctx.needs_input_grad[:2])]
        with torch.enable_grad():
            img = _plain_slope_grid(*leaves, ctx.plan_args)
            wanted = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(img, wanted, g))
        return tuple(next(grads) if x.requires_grad else None for x in leaves) + (None,)


def render_slope_grid_fused(
    volume_zyx: torch.Tensor, tf: torch.Tensor, plan_args: SlopeGridPlanArgs
) -> torch.Tensor:
    """Differentiable slope-space render → (V, U, 4): classify, sweep and
    a recompute backward (:class:`RenderSlopeGridFused`).  Needs
    ``plan_args.swp.classification == "pre"``."""
    if plan_args.swp.classification != "pre":
        raise ValueError("render_slope_grid_fused: the sweep is pre-classified")
    return RenderSlopeGridFused.apply(volume_zyx, tf, plan_args)


def render(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    world_min,
    world_max,
    swp: Optional[sw.ShearWarpParams] = None,
    plan: Optional[sw.ShearWarpPlan] = None,
) -> torch.Tensor:
    """Full shear-warp render through the sweep → (H, W, 4), a drop-in
    for ``shearwarp.render``: :func:`render_slope_grid_fused` and the
    host-planned ``shearwarp.warp_to_screen``."""
    if swp is None:
        swp = sw.ShearWarpParams(n_planes=params.n_samples_per_ray)
    if plan is None:
        plan = sw.make_plan(camera, swp.slope_margin)
    pa = slope_grid_plan_args(plan, world_min, world_max, params, swp)
    inter = render_slope_grid_fused(volume_zyx, tf, pa)
    dev = inter.device
    u0, u1, v0, v1 = plan.bounds
    ug = torch.linspace(u0, u1, swp.inter_size[1], dtype=torch.float32, device=dev)
    vg = torch.linspace(v0, v1, swp.inter_size[0], dtype=torch.float32, device=dev)
    return sw.warp_to_screen(inter, ug, vg, *sw.plan_pixels(plan, dev))


def render_frame(
    chans: torch.Tensor,
    nc_real: int,
    nb_real: int,
    camera: Camera,
    plan_args: SlopeGridPlanArgs,
    content: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Camera → (H, W, 4) screen frame on ``chans``' device: one 43-float
    view vector moves host → device; the sweep tables, the sweep and the
    warp (``shearwarp.warp_frame_device``) run on the device."""
    _check_extents(chans, nc_real, nb_real)
    fv, tables = sweep_operands(chans, plan_args, camera, content)
    inter = pre_sweep(chans, tables, **plan_args.sweep_kwargs())
    return swb.warp_frame(inter, fv, axis=plan_args.axis, viewport=camera.viewport)


def render_slope_grid_sharded(
    mesh,
    chans: torch.Tensor,
    nc_real: int,
    nb_real: int,
    plan_args: SlopeGridPlanArgs,
    content: Optional[torch.Tensor] = None,
    streams=None,
) -> torch.Tensor:
    """The multi-device sweep over a (ray × brick) mesh → (V, U, 4) on the
    mesh's lead device: slope rows over the ray axis (shard vd's first row
    at v0 + dv·vd·V_l), contiguous front-to-back plane ranges of the
    global grid over the brick axis, K5 once per shard on tables cut from
    the frame's global tables, the segments folded in rank order
    (``libre_tpu.ops.shearwarp_pallas.render_slope_grid_sharded``).  V
    must divide the ray-axis size and K the brick-axis size (else
    ValueError)."""
    from libre_tpu_torch.parallel import bricked_sharded as bs
    from libre_tpu_torch.parallel.compositing import move, on_stream
    from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, require_mesh

    require_mesh("render_slope_grid_sharded", mesh)
    _check_extents(chans, nc_real, nb_real)
    v_size, _u = plan_args.swp.inter_size
    v_l, k_l = bs.check_divides(mesh, v_size, plan_args.swp.n_planes)
    _fv, tables = sweep_operands(chans, plan_args)
    dv = tables.view[2]
    parts = [[None] * mesh.shape[BRICK_AXIS] for _ in range(mesh.shape[RAY_AXIS])]
    for vd, kd, dev in mesh.shards():
        with on_stream(streams, dev):
            chans_l = move(chans, dev, streams)
            tables_l = bs.shard_tables(
                tables, rows=slice(vd * v_l, (vd + 1) * v_l),
                planes=slice(kd * k_l, (kd + 1) * k_l),
                v0=tables.view[5] + dv * float(vd * v_l), device=dev,
                na_store=chans.shape[0],
                content=None if content is None else move(content, dev, streams),
                streams=streams,
            )
            parts[vd][kd] = pre_sweep(chans_l, tables_l, **plan_args.sweep_kwargs())
    return bs.fold_rows(mesh, parts, direct=False, streams=streams)
