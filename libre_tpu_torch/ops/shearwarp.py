"""Shear-warp view planning and the slope-grid → screen warp
(``libre_tpu.ops.shearwarp``).

Rays are parameterized by their slope (u, v) = (d_b/d_a, d_c/d_a) with
respect to the volume axis most aligned with the view (the major axis
a); every sample of slope-ray (u, v) on axis plane a = z lies at the
in-plane point (e_b + u·(z − e_a), e_c + v·(z − e_a)).  The sweep kernel
composites a (V, U) grid of such rays; :func:`warp_frame_device` maps
that slope image to screen pixels with one bilinear gather.

The planners are numpy copies of the JAX package's (they run on the
host every frame); the warp is plain torch on the frame's device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from libre_tpu_torch.ops.reference import Camera


@dataclasses.dataclass(frozen=True)
class ShearWarpParams:
    """Static shear-warp configuration."""

    n_planes: int = 256  # K: virtual axis planes = samples per ray
    inter_size: Tuple[int, int] = (256, 256)  # (V, U) slope-grid size
    slope_margin: float = 0.02  # widen the slope bounds by this fraction


# Axis permutations: volume arrays are (Z, Y, X) = world axes (2, 1, 0).
# For major world axis a, permute to (A, C, B) with B the fastest dim.
_PERM = {
    0: (2, 0, 1),  # major x: (X, Z, Y) -> b = y, c = z
    1: (1, 0, 2),  # major y: (Y, Z, X) -> b = x, c = z
    2: (0, 1, 2),  # major z: (Z, Y, X) -> b = x, c = y
}
_BC_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # world (b, c) per major a


def _boundary_slopes_np(camera: Camera, axis: int):
    """Per-pixel slopes (u, v) and the major-axis direction component
    d_a, evaluated on the viewport BOUNDARY pixels only: u = dir_b/dir_a
    is a ratio of functions linear in pixel coordinates, so its extrema
    over the convex viewport lie on the boundary."""
    vx, vy, vw, vh = camera.viewport
    inv_proj = np.asarray(camera.inv_proj, np.float32)
    inv_mv = np.asarray(camera.inv_mv, np.float32)
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    fx = np.concatenate([px, px, np.full(vh, px[0]), np.full(vh, px[-1])])
    fy = np.concatenate([np.full(vw, py[0]), np.full(vw, py[-1]), py, py])
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


def choose_major_axis_np(camera: Camera) -> Tuple[int, float]:
    """Major world axis + marching sign from the central view direction
    (camera looks down −z in eye space)."""
    inv_mv = np.asarray(camera.inv_mv)
    view_dir = -inv_mv[:3, 2]
    axis = int(np.argmax(np.abs(view_dir)))
    return axis, float(np.sign(view_dir[axis]) or 1.0)


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
