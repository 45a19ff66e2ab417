"""Per-pixel ray generation from GL-style camera matrices
(``libre_tpu.ops.rays``).

Reproduces the unprojection of the reference ray loop
(fragRaycast.glsl:64-71,113-147 / cuda Renderer.cu:111-130): window → NDC →
eye space (via the inverse projection, at the far plane) → world space; ray
direction from the eye through the pixel; plus the eye-space near-plane
clamp distance ``tNearPlane``.

Convention: pixel (0, 0) is the *bottom-left* pixel (GL window coords);
``gl_FragCoord`` of pixel (i, j) is (i + 0.5, j + 0.5).  Images produced by
the renderer therefore have row 0 at the bottom; use ``flip_image`` for
top-down display order.

Every function runs on the device of its tensor arguments; the exact
marcher's kernel and its plain version both take the per-ray constants
computed here, so their f32 rounding agrees by construction.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def glsl_rand(co_x: torch.Tensor, co_y: torch.Tensor) -> torch.Tensor:
    """The classic GLSL hash ``fract(sin(dot(co, (12.9898, 78.233))) * 43758.5453)``
    (fragRaycast.glsl:59-62), used for subpixel jitter."""
    return torch.remainder(torch.sin(co_x * 12.9898 + co_y * 78.233) * 43758.5453, 1.0)


@functools.lru_cache(maxsize=32)
def jitter_frag(viewport: Tuple[int, int, int, int], sample_index: int):
    """Jittered fragment coords (fx, fy), each (H, W) f32 numpy, of one
    multi-sample index (fragRaycast.glsl:121-127), computed once on the
    host CPU.

    ``glsl_rand``'s ``fract(43758·sin(·))`` turns an ulp of ``sin`` into a
    visible jitter change, so ``make_rays`` takes every jittered sample's
    grid from here, whatever its device: a frame on the card and the same
    frame on the CPU then march the same rays.  Callers must not write to
    the returned arrays (they are cached)."""
    vx, vy, vw, vh = viewport
    px = torch.arange(vw, dtype=torch.float32) + 0.5 + vx
    py = torch.arange(vh, dtype=torch.float32) + 0.5 + vy
    fy, fx = torch.meshgrid(py, px, indexing="ij")
    i = float(sample_index)
    fx = fx + glsl_rand(fx * i, fy * i) * 0.5
    fy = fy + glsl_rand(fx * 2 * i, fy * 2 * i) * 0.5
    return fx.numpy(), fy.numpy()


def make_rays(
    inv_proj,
    inv_mv,
    viewport: Tuple[int, int, int, int],
    sample_index: int = 0,
    frag_override=None,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build per-pixel rays for a viewport on ``device``.

    Returns (eye (3,), dirs (H, W, 3), cos_z (H, W), frag (H, W, 2)).
    ``sample_index`` selects the jittered subpixel position of
    multi-sample rendering (fragRaycast.glsl:121-127), from
    :func:`jitter_frag`'s host grid; index 0 yields zero jitter, the
    single-sample default.  ``frag_override`` = (fx, fy) supplies the
    fragment coords instead.
    """
    vx, vy, vw, vh = viewport
    f32 = torch.float32
    inv_proj = torch.as_tensor(np.asarray(inv_proj, np.float32), device=device)
    inv_mv = torch.as_tensor(np.asarray(inv_mv, np.float32), device=device)

    if frag_override is None and sample_index > 0:
        frag_override = jitter_frag(tuple(viewport), sample_index)
    if frag_override is not None:
        fx = torch.as_tensor(np.asarray(frag_override[0], np.float32), device=device)
        fy = torch.as_tensor(np.asarray(frag_override[1], np.float32), device=device)
    else:
        px = torch.arange(vw, dtype=f32, device=device) + 0.5 + vx
        py = torch.arange(vh, dtype=f32, device=device) + 0.5 + vy
        fy, fx = torch.meshgrid(py, px, indexing="ij")  # (H, W)

    # Window → NDC (fragRaycast.glsl:67-68); note z_ndc = w_ndc = 1.
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = torch.ones_like(ndc_x)
    ndc = torch.stack([ndc_x, ndc_y, ones, ones], dim=-1)  # (H, W, 4)

    eye_space = ndc @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]

    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    # Ray distance to the eye-space near plane (fragRaycast.glsl:145-147):
    # t = dot(n, (0,0,-near)) / dot(n, normalize(eyePos)) with n = (0,0,1);
    # return the cosine term so that t_near_plane = -near / cos_z.
    eye_dir = eye_space[..., :3]
    eye_dir = eye_dir / torch.linalg.norm(eye_dir, dim=-1, keepdim=True)
    cos_z = eye_dir[..., 2]
    frag = torch.stack([fx, fy], dim=-1)
    return eye, dirs, cos_z, frag


def near_plane_t(cos_z: torch.Tensor, near: float) -> torch.Tensor:
    """Ray parameter of the near-plane crossing: ``-near / cos_z``."""
    return -near / cos_z


def flip_image(img: torch.Tensor) -> torch.Tensor:
    """Convert a GL bottom-up image to top-down row order."""
    return torch.flip(img, dims=[0])


def intersect_box(
    origin: torch.Tensor,
    direction: torch.Tensor,
    box_min,
    box_max,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ray/AABB slab intersection (fragRaycast.glsl:80-102).

    Broadcasts over leading dims.  Returns (t0, t1, hit) with hit = t0 <= t1.
    Zero direction components are nudged to ``eps`` exactly like the
    reference to avoid division by zero.
    """
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=direction.device)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=direction.device)
    d = torch.where(direction == 0.0, torch.full_like(direction, eps), direction)
    inv = 1.0 / d
    tbot = inv * (box_min - origin)
    ttop = inv * (box_max - origin)
    tmin = torch.minimum(ttop, tbot)
    tmax = torch.maximum(ttop, tbot)
    t0 = torch.amax(tmin, dim=-1)
    t1 = torch.amin(tmax, dim=-1)
    return t0, t1, t0 <= t1


def clip_ray(
    origin: torch.Tensor,
    direction: torch.Tensor,
    t_near: torch.Tensor,
    t_far: torch.Tensor,
    clip_planes,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp a ray's [t_near, t_far] interval by clip planes
    (fragRaycast.glsl:162-174).  ``clip_planes`` is a (P, 4) array."""
    for p in np.asarray(clip_planes, np.float32):
        normal = torch.as_tensor(p[:3], device=direction.device)
        rn = direction @ normal
        rn = torch.where(rn == 0.0, torch.full_like(rn, eps), rn)
        t = -((origin @ normal) + float(p[3])) / rn
        t_near = torch.where(rn > 0.0, torch.maximum(t_near, t), t_near)
        t_far = torch.where(rn > 0.0, t_far, torch.minimum(t_far, t))
    return t_near, t_far
