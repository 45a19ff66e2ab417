"""Shear-warp view planning, the plain shear-warp pipeline and the
slope-grid → screen warps (``libre_tpu.ops.shearwarp``).

Rays are parameterized by their slope (u, v) = (d_b/d_a, d_c/d_a) with
respect to the volume axis most aligned with the view (the major axis
a); every sample of slope-ray (u, v) on axis plane a = z lies at the
in-plane point (e_b + u·(z − e_a), e_c + v·(z − e_a)).  A sweep
composites a (V, U) grid of such rays; :func:`warp_to_screen` and
:func:`warp_frame_device` map that slope image to screen pixels with one
bilinear gather.

:func:`render_slope_grid` is the plain pipeline: K virtual planes, each
the axis lerp of two slices, resampled onto the slope grid by two-tap
interpolation matrices (batched products), then composited front to
back in closed form with the exact early exit.  Classification ``pre``
applies the transfer function per voxel and interpolates RGBA; ``post``
interpolates density and classifies per sample.  It is plain torch,
differentiable by autograd: the dense renderer's CPU backend and the
recompute behind the backward of ``shearwarp_dense``'s fused sweep.

The planners are numpy copies of the JAX package's (they run on the
host every frame).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.reference import ALPHA_CLAMP, Camera, RenderParams
from libre_tpu_torch.ops.transfer_function import lookup, lookup_reference
from libre_tpu_torch.utils.profiling import span

CLASSIFICATIONS = ("pre", "post")
COMPUTE_DTYPES = ("float32", "bfloat16")


def resample_rounding(compute_dtype: str):
    """The rounding of a resample operand under ``compute_dtype``: to
    bf16 and back (round to nearest even) for "bfloat16", none for
    "float32"."""
    if compute_dtype == "float32":
        return lambda x: x
    if compute_dtype == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"compute_dtype {compute_dtype!r} is not one of {COMPUTE_DTYPES}")


def tap_weights(i0: torch.Tensor, i1: torch.Tensor, w: torch.Tensor, compute_dtype: str):
    """The two taps' weights of a resample stage as the JAX kernels'
    interpolation matrix holds them (``_interp_matrix``): (1 − w, w) in
    float32; under "bfloat16" each rounded on its own, and where the edge
    clamp makes i0 = i1 the one entry (1 − w) + w on tap i0."""
    if compute_dtype == "float32":
        return 1.0 - w, w
    rnd = resample_rounding(compute_dtype)
    edge = i0 == i1
    return (
        rnd(torch.where(edge, (1.0 - w) + w, 1.0 - w)),
        rnd(torch.where(edge, torch.zeros_like(w), w)),
    )


@dataclasses.dataclass(frozen=True)
class ShearWarpParams:
    """Static shear-warp configuration."""

    n_planes: int = 256  # K: virtual axis planes = samples per ray
    inter_size: Tuple[int, int] = (256, 256)  # (V, U) slope-grid size
    slope_margin: float = 0.02  # widen the slope bounds by this fraction
    classification: str = "pre"  # "pre" | "post"
    # Resample operand type of the sweep kernels K1 and K5 (and their
    # plain versions): "bfloat16" rounds both operands of each of the two
    # resample stages to bf16 and sums in f32, as the JAX kernels' products
    # do; compositing stays f32.  The plain pipeline of this module and the
    # store trainer's gradient path compute in float32 whatever it says, as
    # the JAX package's do.
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.classification not in CLASSIFICATIONS:
            raise ValueError(
                f"ShearWarpParams: classification {self.classification!r} "
                f"is not one of {CLASSIFICATIONS}"
            )
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"ShearWarpParams: compute_dtype {self.compute_dtype!r} is not one "
                f"of {COMPUTE_DTYPES}"
            )


# Axis permutations: volume arrays are (Z, Y, X) = world axes (2, 1, 0).
# For major world axis a, permute to (A, C, B) with B the fastest dim.
_PERM = {
    0: (2, 0, 1),  # major x: (X, Z, Y) -> b = y, c = z
    1: (1, 0, 2),  # major y: (Y, Z, X) -> b = x, c = z
    2: (0, 1, 2),  # major z: (Z, Y, X) -> b = x, c = y
}
_BC_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # world (b, c) per major a


def _slopes_np(camera: Camera, axis: int, fx: np.ndarray, fy: np.ndarray):
    """Slopes (u, v) and the major-axis direction component d_a of the
    rays through fragment coordinates (fx, fy) (``rays.make_rays`` math,
    sample 0, in numpy f32)."""
    vx, vy, vw, vh = camera.viewport
    inv_proj = np.asarray(camera.inv_proj, np.float32)
    inv_mv = np.asarray(camera.inv_mv, np.float32)
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = np.ones_like(ndc_x)
    ndc = np.stack([ndc_x, ndc_y, ones, ones], axis=-1)
    eye_space = ndc @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b, c = _BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = np.where(np.abs(d_a) < 1e-6, np.float32(1e-6), d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


def _pixel_coords_np(camera: Camera):
    vx, vy, vw, vh = camera.viewport
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    return px, py


def _pixel_slopes_np(camera: Camera, axis: int):
    """Per-pixel slopes (u (H, W), v (H, W), d_a (H, W)) on the host, for
    :func:`make_plan`."""
    px, py = _pixel_coords_np(camera)
    fx, fy = np.meshgrid(px, py, indexing="xy")
    return _slopes_np(camera, axis, fx, fy)


def _boundary_slopes_np(camera: Camera, axis: int):
    """:func:`_pixel_slopes_np` on the viewport BOUNDARY pixels only:
    u = dir_b/dir_a is a ratio of functions linear in pixel coordinates,
    so its extrema over the convex viewport lie on the boundary."""
    px, py = _pixel_coords_np(camera)
    vh, vw = len(py), len(px)
    fx = np.concatenate([px, px, np.full(vh, px[0]), np.full(vh, px[-1])])
    fy = np.concatenate([np.full(vw, py[0]), np.full(vw, py[-1]), py, py])
    return _slopes_np(camera, axis, fx, fy)


def choose_major_axis_np(camera: Camera) -> Tuple[int, float]:
    """Major world axis + marching sign from the central view direction
    (camera looks down −z in eye space)."""
    inv_mv = np.asarray(camera.inv_mv)
    view_dir = -inv_mv[:3, 2]
    axis = int(np.argmax(np.abs(view_dir)))
    return axis, float(np.sign(view_dir[axis]) or 1.0)


choose_major_axis = choose_major_axis_np


def pixel_slopes(camera: Camera, axis: int, device="cuda"):
    """Per-pixel slopes (u, v) w.r.t. the major axis and the major-axis
    direction component d_a (whose sign must match the marching sign),
    each (H, W) on ``device``."""
    _, dirs, _, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport, device=device
    )
    b, c = _BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = torch.where(torch.abs(d_a) < 1e-6, torch.full_like(d_a, 1e-6), d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


@dataclasses.dataclass(frozen=True)
class ViewPlan:
    """Per-view plan: major axis, marching sign, slope bounds, eye."""

    axis: int
    sign: float
    bounds: Tuple[float, float, float, float]
    eye: np.ndarray


def make_view_plan(camera: Camera, margin: float = 0.02) -> ViewPlan:
    axis, sign = choose_major_axis_np(camera)
    u, v, d_a = _boundary_slopes_np(camera, axis)
    return ViewPlan(
        axis=axis,
        sign=sign,
        bounds=_slope_bounds(u, v, d_a, sign, margin),
        eye=np.asarray(camera.inv_mv)[:3, 3].astype(np.float32),
    )


def _slope_bounds(u, v, d_a, sign, margin):
    """Slope-grid bounds over forward-marching pixels."""
    u = np.asarray(u)
    v = np.asarray(v)
    ok = np.sign(np.asarray(d_a)) == sign
    if not ok.any():
        return (-1.0, 1.0, -1.0, 1.0)
    uu, vv = u[ok], v[ok]
    du = (uu.max() - uu.min()) * margin + 1e-6
    dv = (vv.max() - vv.min()) * margin + 1e-6
    return (
        float(uu.min() - du),
        float(uu.max() + du),
        float(vv.min() - dv),
        float(vv.max() + dv),
    )


@dataclasses.dataclass(frozen=True)
class ShearWarpPlan:
    """Per-view plan with the per-pixel slopes of the screen warp."""

    axis: int
    sign: float
    bounds: Tuple[float, float, float, float]
    eye: np.ndarray  # (3,)
    u: np.ndarray  # (H, W) per-pixel slopes
    v: np.ndarray
    valid: np.ndarray  # (H, W) forward-marching mask


def make_plan(camera: Camera, margin: float = 0.02) -> ShearWarpPlan:
    axis, sign = choose_major_axis_np(camera)
    u, v, d_a = _pixel_slopes_np(camera, axis)
    return ShearWarpPlan(
        axis=axis,
        sign=sign,
        bounds=_slope_bounds(u, v, d_a, sign, margin),
        eye=np.asarray(camera.inv_mv)[:3, 3].astype(np.float32),
        u=u,
        v=v,
        valid=(np.sign(d_a) == sign),
    )


# ============================================================ plain pipeline
def _lerp_matrix(coords: torch.Tensor, n: int, inside: torch.Tensor) -> torch.Tensor:
    """(..., M) fractional voxel coords → (..., n, M) two-tap linear
    interpolation matrix with clamp-to-edge, zeroed outside the box."""
    s = torch.clamp(coords, -0.5, n - 0.5)
    i0f = torch.floor(torch.clamp(s, 0.0, float(n - 1)))
    w = torch.clamp(s - i0f, 0.0, 1.0)
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    grid = torch.arange(n, device=coords.device)[:, None]  # (n, 1)
    m = (grid == i0[..., None, :]) * (1.0 - w[..., None, :]) + (
        grid == i1[..., None, :]
    ) * w[..., None, :]
    return m * inside[..., None, :]


def precompute_classified_volume(volume_zyx, tf, data_source_range):
    """Pre-classification: the TF applied per voxel → 4 channel volumes,
    under the span ``libre.dense.classify``; each call adds one to
    ``precompute_classified_volume.calls``."""
    precompute_classified_volume.calls += 1
    with span("libre.dense.classify"):
        lo, hi = data_source_range
        density = torch.clamp((volume_zyx.to(torch.float32) - lo) / (hi - lo), 0.0, 1.0)
        rgba = lookup(tf, density)  # (Z, Y, X, 4)
        return tuple(rgba[..., i] for i in range(4))


precompute_classified_volume.calls = 0


def _exclusive_cumprod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``concat([1, cumprod(x)[:-1]])`` along ``dim``."""
    x = x.movedim(dim, 0)
    out = torch.cat([torch.ones_like(x[:1]), torch.cumprod(x, dim=0)[:-1]], dim=0)
    return out.movedim(0, dim)


def _composite_planes(slab_r, slab_g, slab_b, alpha, corr, early_exit):
    """Closed-form front-to-back compositing along the plane axis (K
    leading) with the exact early exit: a plane contributes while the
    alpha accumulated before it is ≤ ``early_exit``."""
    a_corr = 1.0 - torch.pow(1.0 - torch.clamp(alpha, max=ALPHA_CLAMP), corr[None])
    t_excl_u = _exclusive_cumprod(1.0 - a_corr, dim=0)
    global_before = 1.0 - t_excl_u
    m = (global_before <= early_exit).to(a_corr.dtype)
    a_eff = a_corr * m
    t_excl = _exclusive_cumprod(1.0 - a_eff, dim=0)
    w = a_eff * t_excl
    out_r = torch.sum(w * slab_r, dim=0)
    out_g = torch.sum(w * slab_g, dim=0)
    out_b = torch.sum(w * slab_b, dim=0)
    out_a = 1.0 - torch.prod(1.0 - a_eff, dim=0)
    return out_r, out_g, out_b, out_a


def render_slope_grid(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    eye,  # (3,) world
    axis: int,
    sign: float,
    slope_bounds: Tuple[float, float, float, float],
    world_min,
    world_max,
    params: RenderParams,
    swp: ShearWarpParams,
):
    """The shear and composite stages on ``volume_zyx``'s device → (V, U,
    4) slope-space image.  Returns (image, u_grid (U,), v_grid (V,))."""
    dev = volume_zyx.device
    f32 = torch.float32
    K = swp.n_planes
    V, U = swp.inter_size
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    eye = np.asarray(eye, np.float32)
    perm = _PERM[axis]
    b_axis, c_axis = _BC_AXES[axis]

    if swp.classification == "pre":
        # TF applied per voxel, RGBA interpolated.
        chans = precompute_classified_volume(volume_zyx, tf, params.data_source_range)
    else:
        # Post-classification: interpolate DENSITY, classify per sample.
        lo, hi = params.data_source_range
        chans = [(volume_zyx.to(f32) - lo) / (hi - lo)]
    chans = [ch.permute(perm) for ch in chans]  # each (A, C, B)
    Na, Nc, Nb = chans[0].shape

    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    wb0, wb1 = float(wmin[b_axis]), float(wmax[b_axis])
    wc0, wc1 = float(wmin[c_axis]), float(wmax[c_axis])
    ea, eb, ec = (torch.tensor(float(eye[i]), dtype=f32, device=dev)
                  for i in (axis, b_axis, c_axis))

    # Plane positions, front-to-back in the marching direction.
    dz = (wa1 - wa0) / K
    j = torch.arange(K, dtype=f32, device=dev)
    z = wa0 + (j + 0.5) * dz if sign > 0 else wa1 - (j + 0.5) * dz  # (K,)

    u0, u1, v0, v1 = slope_bounds
    ug = torch.linspace(u0, u1, U, dtype=f32, device=dev)
    vg = torch.linspace(v0, v1, V, dtype=f32, device=dev)

    # Axis-lerp matrix A (K, Na): a virtual plane is the lerp of two slices.
    sa = (z - wa0) / (wa1 - wa0) * Na - 0.5
    A = _lerp_matrix(sa[None, :], Na, torch.ones((1, K), dtype=f32, device=dev))[0].T

    # Per-plane in-plane interpolation matrices (affine in u / v).
    delta = (z - ea)[:, None]  # (K, 1)
    xb = eb + ug[None, :] * delta  # (K, U) world b-coords
    inside_b = ((xb >= wb0) & (xb < wb1)).to(f32)
    Mb = _lerp_matrix((xb - wb0) / (wb1 - wb0) * Nb - 0.5, Nb, inside_b)  # (K, Nb, U)
    xc = ec + vg[None, :] * delta  # (K, V)
    inside_c = ((xc >= wc0) & (xc < wc1)).to(f32)
    Mc = _lerp_matrix((xc - wc0) / (wc1 - wc0) * Nc - 0.5, Nc, inside_c)  # (K, Nc, V)

    # Per-ray opacity-correction exponent: the Euclidean step dz·√(1+u²+v²)
    # relative to the reference step.
    length = torch.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)  # (V, U)
    corr = params.max_samples_per_ray * dz * length

    slabs = []
    for ch in chans:
        vs = torch.einsum("ka,acb->kcb", A, ch)  # (K, Nc, Nb) virtual planes
        s1 = torch.einsum("kcb,kbu->kcu", vs, Mb)  # resample b → u
        slabs.append(torch.einsum("kcu,kcv->kvu", s1, Mc))  # c → v: (K, V, U)

    if swp.classification != "pre":
        # The matrices zero OUTSIDE-box samples; tf(0) may be opaque, so
        # mask alpha with the inside indicator explicitly.
        rgba = lookup(tf, slabs[0])  # (K, V, U, 4)
        inside = inside_c[:, :, None] * inside_b[:, None, :]  # (K, V, U)
        slabs = [rgba[..., 0], rgba[..., 1], rgba[..., 2], rgba[..., 3] * inside]

    out = _composite_planes(*slabs, corr, params.early_exit)
    return torch.stack(out, dim=-1), ug, vg


def warp_to_screen(
    inter: torch.Tensor,  # (V, U, 4) slope-space image
    ug: torch.Tensor,
    vg: torch.Tensor,
    u: torch.Tensor,  # (H, W) per-pixel slopes
    v: torch.Tensor,
    valid: torch.Tensor,  # (H, W) forward-marching mask
) -> torch.Tensor:
    """The 2-D bilinear warp slope space → screen (one gather)."""
    V, U, _ = inter.shape
    du = (ug[-1] - ug[0]) / (U - 1)
    dv = (vg[-1] - vg[0]) / (V - 1)
    gu = torch.clamp((u - ug[0]) / du, 0.0, U - 1.0)
    gv = torch.clamp((v - vg[0]) / dv, 0.0, V - 1.0)
    iu0 = torch.floor(gu).long()
    iv0 = torch.floor(gv).long()
    iu1 = torch.clamp(iu0 + 1, max=U - 1)
    iv1 = torch.clamp(iv0 + 1, max=V - 1)
    wu = (gu - iu0)[..., None]
    wv = (gv - iv0)[..., None]
    flat = inter.reshape(V * U, 4)

    def g(iv, iu):
        return flat[iv * U + iu]  # (H, W, 4)

    top = g(iv0, iu0) * (1 - wu) + g(iv0, iu1) * wu
    bot = g(iv1, iu0) * (1 - wu) + g(iv1, iu1) * wu
    out = top * (1 - wv) + bot * wv
    return out * valid[..., None]


def render(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    world_min,
    world_max,
    swp: Optional[ShearWarpParams] = None,
    plan: Optional[ShearWarpPlan] = None,
) -> torch.Tensor:
    """Full plain shear-warp render → (H, W, 4) on ``volume_zyx``'s
    device (bottom-up rows, like GL)."""
    if swp is None:
        swp = ShearWarpParams(n_planes=params.n_samples_per_ray)
    if plan is None:
        plan = make_plan(camera, swp.slope_margin)
    inter, ug, vg = render_slope_grid(
        volume_zyx, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
        world_min, world_max, params, swp,
    )
    return warp_to_screen(inter, ug, vg, *plan_pixels(plan, inter.device))


def plan_pixels(plan: ShearWarpPlan, device):
    """The plan's per-pixel (u, v, valid) as tensors on ``device``."""
    return tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in (plan.u, plan.v, plan.valid)
    )


def warp_frame_device(
    inter: torch.Tensor,  # (V, U, 4) slope-space image
    inv_proj: torch.Tensor,  # (4, 4) f32
    inv_mv: torch.Tensor,  # (4, 4) f32
    u0, du, dv, v0, sign,  # view scalars: 0-d f32 tensors on inter's device
    *,
    axis: int,
    viewport: Tuple[int, int, int, int],
) -> torch.Tensor:
    """Camera → screen warp on the frame's device: per-pixel slopes from
    the 4×4 matrices (sample 0 of each pixel), then a bilinear warp of
    the slope image as one gather of 2×2 patches → (H, W, 4)."""
    v_size, u_size = inter.shape[0], inter.shape[1]
    dev = inter.device
    b_axis, c_axis = _BC_AXES[axis]
    vx, vy, vw, vh = viewport
    px = torch.arange(vw, dtype=torch.float32, device=dev) + 0.5 + vx
    py = torch.arange(vh, dtype=torch.float32, device=dev) + 0.5 + vy
    fy, fx = torch.meshgrid(py, px, indexing="ij")
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = torch.ones_like(ndc_x)
    ndc = torch.stack([ndc_x, ndc_y, ones, ones], dim=-1)
    eye_space = ndc @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    d_a = dirs[..., axis]
    safe = torch.where(torch.abs(d_a) < 1e-6, torch.full_like(d_a, 1e-6), d_a)
    u = dirs[..., b_axis] / safe
    v = dirs[..., c_axis] / safe
    valid = (torch.sign(d_a) == sign).to(torch.float32)

    gu = torch.clamp((u - u0) / du, 0.0, u_size - 1.0)
    gv = torch.clamp((v - v0) / dv, 0.0, v_size - 1.0)
    iu0f = torch.floor(gu)
    iv0f = torch.floor(gv)
    wu = (gu - iu0f)[..., None]
    wv = (gv - iv0f)[..., None]
    right = torch.cat([inter[:, 1:], inter[:, -1:]], dim=1)
    down = torch.cat([inter[1:], inter[-1:]], dim=0)
    diag = torch.cat([right[1:], right[-1:]], dim=0)
    quad = torch.cat([inter, right, down, diag], dim=-1).reshape(
        v_size * u_size, 16
    )
    g = quad[iv0f.long() * u_size + iu0f.long()]  # (H, W, 16)
    top = g[..., 0:4] * (1 - wu) + g[..., 4:8] * wu
    bot = g[..., 8:12] * (1 - wu) + g[..., 12:16] * wu
    return (top * (1 - wv) + bot * wv) * valid[..., None]


# ================================================================= oracle
def plane_oracle(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    eye: np.ndarray,
    axis: int,
    sign: float,
    slopes_uv: Tuple[torch.Tensor, torch.Tensor],  # (R,), (R,) slope rays
    world_min,
    world_max,
    params: RenderParams,
    n_planes: int,
    classification: str = "pre",
    clip_planes_world=None,
    sentinel_mask: bool = False,
) -> torch.Tensor:
    """Gather-based marcher over the sample set of
    :func:`render_slope_grid` (each slope ray's points on the K axis
    planes, trilinear, the same opacity correction and early exit) →
    (R, 4), on ``volume_zyx``'s device.  Slow; the exactness oracle of
    the matrix pipeline and of the sweeps, differentiable by autograd.
    Nothing on a render path calls it.

    ``clip_planes_world``: optional (N, 4) rows [nx, ny, nz, d]; samples
    where n·x + d < 0 are dropped (the per-sample form of the
    fragRaycast.glsl:162-174 ray-interval clamp, equal for convex sets).
    ``sentinel_mask``: in "post" mode, drop samples whose interpolated
    density is < −0.5 (the bricked path's uncovered-voxel SENTINEL)."""
    from libre_tpu_torch.ops.reference import sample_density

    dev = volume_zyx.device
    f32 = torch.float32
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    eye = np.asarray(eye, np.float32)
    b_axis, c_axis = _BC_AXES[axis]
    u, v = (torch.as_tensor(s, dtype=f32, device=dev) for s in slopes_uv)
    K = n_planes
    wa0, wa1 = float(wmin[axis]), float(wmax[axis])
    dz = (wa1 - wa0) / K
    j = torch.arange(K, dtype=f32, device=dev)
    z = wa0 + (j + 0.5) * dz if sign > 0 else wa1 - (j + 0.5) * dz  # (K,)

    if classification == "pre":
        rgba_vol = torch.stack(
            precompute_classified_volume(volume_zyx, tf, params.data_source_range), dim=-1
        )  # (Z, Y, X, 4)
    else:
        lo, hi = params.data_source_range
        dens_vol = (volume_zyx.to(f32) - lo) / (hi - lo)

    length = torch.sqrt(1.0 + u ** 2 + v ** 2)  # (R,)
    corr = params.max_samples_per_ray * dz * length

    delta = z[None, :] - float(eye[axis])  # (1, K)
    pb = float(eye[b_axis]) + u[:, None] * delta  # (R, K)
    pc = float(eye[c_axis]) + v[:, None] * delta

    inside = (
        (pb >= float(wmin[b_axis])) & (pb < float(wmax[b_axis]))
        & (pc >= float(wmin[c_axis])) & (pc < float(wmax[c_axis]))
    )
    if clip_planes_world is not None and len(clip_planes_world):
        pa = torch.broadcast_to(z[None, :], pb.shape)
        world = {axis: pa, b_axis: pb, c_axis: pc}
        for row in np.asarray(clip_planes_world, np.float32).reshape(-1, 4):
            nx, ny, nz, d = (float(x) for x in row)
            inside = inside & (nx * world[0] + ny * world[1] + nz * world[2] + d >= 0.0)

    # world → tex (whole volume, no padding); world axes (0, 1, 2) = (x, y, z).
    def tex(p, lo, hi):
        return (p - lo) / (hi - lo)

    coords = {
        axis: torch.broadcast_to(tex(z, wa0, wa1)[None, :], pb.shape),
        b_axis: tex(pb, float(wmin[b_axis]), float(wmax[b_axis])),
        c_axis: tex(pc, float(wmin[c_axis]), float(wmax[c_axis])),
    }
    tex_pos = torch.stack([coords[0], coords[1], coords[2]], dim=-1)

    if classification == "pre":
        rgba = torch.stack(
            [sample_density(rgba_vol[..., ch], tex_pos, "trilinear") for ch in range(4)],
            dim=-1,
        )  # (R, K, 4)
    else:
        dens = sample_density(dens_vol, tex_pos, "trilinear")  # (R, K)
        rgba = lookup_reference(tf, dens)  # outside masked through a_v below
        if sentinel_mask:
            inside = inside & (dens > -0.5)

    a_corr = 1.0 - torch.pow(1.0 - torch.clamp(rgba[..., 3], max=ALPHA_CLAMP), corr[:, None])
    a_v = a_corr * inside.to(f32)
    t_excl_u = _exclusive_cumprod(1.0 - a_v, dim=1)
    m = ((1.0 - t_excl_u) <= params.early_exit).to(f32)
    a_eff = a_v * m
    w = a_eff * _exclusive_cumprod(1.0 - a_eff, dim=1)
    out_rgb = torch.einsum("rk,rkc->rc", w, rgba[..., :3])
    out_a = 1.0 - torch.prod(1.0 - a_eff, dim=1)
    return torch.cat([out_rgb, out_a[:, None]], dim=-1)
