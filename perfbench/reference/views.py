"""What a camera fixes, worked out from the camera alone: the shear-warp
view vector of a slope grid, and the exact marcher's per-ray constants.

Plain numpy and torch; the renderer's conventions (Livre's
fragRaycast.glsl:64-158 and GLRaycastRenderer.cpp): pixel (0, 0) at the
bottom left, rays from the eye through the far-plane unprojection of
each pixel centre, the global sample grid t_n = tn_global + n·step."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# World (b, c) axes of each major axis a; the store is (A, C, B).
BC_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _slopes(cam: Dict, axis: int, fx: np.ndarray, fy: np.ndarray):
    vx, vy, vw, vh = cam["viewport"]
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = np.ones_like(ndc_x)
    eye_space = np.stack([ndc_x, ndc_y, ones, ones], axis=-1) @ cam["inv_proj"].T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ cam["inv_mv"].T
    dirs = world[..., :3] - cam["inv_mv"][:3, 3]
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    b, c = BC_AXES[axis]
    d_a = dirs[..., axis]
    safe = np.where(np.abs(d_a) < 1e-6, np.float32(1e-6), d_a)
    return dirs[..., b] / safe, dirs[..., c] / safe, d_a


def shearwarp_view(cam: Dict, world_min, world_max, inter_size: Tuple[int, int],
                   margin: float, max_samples_per_ray: float):
    """(view vector (11,) f32 [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0,
    sign, msr], major axis, sign) of the slope grid of ``cam``: the major
    axis and march sign from the central view direction, the slope bounds
    over the forward-marching boundary pixels widened by ``margin``."""
    inv_mv = np.asarray(cam["inv_mv"])
    view_dir = -inv_mv[:3, 2]
    axis = int(np.argmax(np.abs(view_dir)))
    sign = float(np.sign(view_dir[axis]) or 1.0)
    vx, vy, vw, vh = cam["viewport"]
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    fx = np.concatenate([px, px, np.full(vh, px[0]), np.full(vh, px[-1])])
    fy = np.concatenate([np.full(vw, py[0]), np.full(vw, py[-1]), py, py])
    u, v, d_a = _slopes(cam, axis, fx, fy)
    ok = np.sign(d_a) == sign
    uu, vv = u[ok], v[ok]
    du = (uu.max() - uu.min()) * margin + 1e-6
    dv = (vv.max() - vv.min()) * margin + 1e-6
    u0, u1, v0, v1 = (float(uu.min() - du), float(uu.max() + du),
                      float(vv.min() - dv), float(vv.max() + dv))
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = BC_AXES[axis]
    eye = inv_mv[:3, 3].astype(np.float32)
    v_size, u_size = inter_size
    vs = np.float32([
        wmin[axis], wmax[axis], eye[axis], u0, (u1 - u0) / (u_size - 1),
        (v1 - v0) / (v_size - 1), eye[b_axis], eye[c_axis], v0, sign,
        max_samples_per_ray,
    ])
    return vs, axis, sign


def intersect_box(origin, direction, box_min, box_max, eps=1e-10):
    box_min = torch.as_tensor(box_min, dtype=torch.float32, device=direction.device)
    box_max = torch.as_tensor(box_max, dtype=torch.float32, device=direction.device)
    d = torch.where(direction == 0.0, torch.full_like(direction, eps), direction)
    inv = 1.0 / d
    tbot = inv * (box_min - origin)
    ttop = inv * (box_max - origin)
    t0 = torch.amax(torch.minimum(ttop, tbot), dim=-1)
    t1 = torch.amin(torch.maximum(ttop, tbot), dim=-1)
    return t0, t1


def exact_rays(cam: Dict, step: float, global_min, global_max, device) -> Dict:
    """Per-ray constants of the exact march over the global box: eye (3,),
    dirs (R, 3), the near-plane t, the global entry and exit t, and the
    first sample past the near plane, each (R,) f32 on ``device``."""
    vx, vy, vw, vh = cam["viewport"]
    f32 = torch.float32
    inv_proj = torch.as_tensor(cam["inv_proj"], device=device)
    inv_mv = torch.as_tensor(cam["inv_mv"], device=device)
    px = torch.arange(vw, dtype=f32, device=device) + 0.5 + vx
    py = torch.arange(vh, dtype=f32, device=device) + 0.5 + vy
    fy, fx = torch.meshgrid(py, px, indexing="ij")
    ndc_x = 2.0 * (fx - vx - vw / 2.0) / vw
    ndc_y = 2.0 * (fy - vy - vh / 2.0) / vh
    ones = torch.ones_like(ndc_x)
    eye_space = torch.stack([ndc_x, ndc_y, ones, ones], dim=-1) @ inv_proj.T
    eye_space = eye_space / eye_space[..., 3:4]
    world = eye_space @ inv_mv.T
    eye = inv_mv[:3, 3]
    dirs = world[..., :3] - eye
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    eye_dir = eye_space[..., :3]
    eye_dir = eye_dir / torch.linalg.norm(eye_dir, dim=-1, keepdim=True)
    t_near_plane = (-cam["near"] / eye_dir[..., 2]).reshape(-1)
    dirs = dirs.reshape(-1, 3)
    tn_global, t_exit = intersect_box(eye, dirs, global_min, global_max)
    n_start = torch.ceil(torch.clamp(t_near_plane - tn_global, min=0.0) / step)
    eye_host = tuple(float(v) for v in np.asarray(cam["inv_mv"], np.float32)[:3, 3])
    return {"eye": eye, "eye_host": eye_host, "dirs": dirs, "t_near_plane": t_near_plane,
            "tn_global": tn_global, "hit": tn_global <= t_exit, "n_start": n_start}


def max_steps(world_min, world_max, step: float) -> int:
    """The march length of a brick: its diagonal over the step, plus 4."""
    diag = np.linalg.norm(np.asarray(world_max, np.float32) - np.asarray(world_min, np.float32))
    return int(math.ceil(float(diag) / step)) + 4
