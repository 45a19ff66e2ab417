"""The benchmark's inputs: cameras on the orbit (turned by ``--seed``),
the volumes (fixed by the configuration), the colormap.  The program and
the reference get the same ones; neither makes its own.  Plain numpy and
torch only."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


def default_color_map(size: int = 256) -> np.ndarray:
    """The renderer's default colormap (hue ramp, linear alpha), (size, 4)
    f32 in [0, 1]."""
    x = np.linspace(0.0, 1.0, size, dtype=np.float32)
    r = np.clip(1.5 * x - 0.25, 0, 1)
    g = np.clip(1.5 * np.abs(x - 0.5) * -1 + 1.0, 0, 1) * x
    b = np.clip(1.0 - 1.5 * x, 0, 1) + 0.2 * x
    return np.stack([r, g, np.clip(b, 0, 1), x], axis=-1).astype(np.float32)


def color_map(size: int, device) -> torch.Tensor:
    """:func:`default_color_map` as an f32 tensor on ``device``."""
    return torch.from_numpy(default_color_map(size)).to(device)


def _perspective(fovy_deg, aspect, near, far):
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _look_at(eye, center, up):
    eye, center, up = (np.asarray(v, np.float64) for v in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def camera(width: int, height: int, eye, near: float = 0.1, far: float = 15.0) -> Dict:
    """A GL camera looking from ``eye`` at the origin, 50° vertical field
    of view: {"inv_proj", "inv_mv" (4, 4) f32, "viewport", "near"}."""
    mv = _look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = _perspective(50.0, width / height, near, far)
    return {
        "inv_proj": np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        "inv_mv": np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        "viewport": (0, 0, int(width), int(height)),
        "near": float(proj[2, 3] / (proj[2, 2] - 1.0)),
    }


def orbit(orbit_cfg: Dict, width: int, height: int, seed: int) -> List[Dict]:
    """The orbit's poses: ``poses`` eyes at ``distance`` on an arc of
    ``azimuth_deg`` = [lo, hi] about the y axis at height ``height``,
    the whole arc turned by an offset drawn from ``seed`` within
    ``jitter_deg``, so every seed renders as many poses of the same
    sizes from other angles."""
    rng = np.random.default_rng(seed)
    lo, hi = orbit_cfg["azimuth_deg"]
    offset = rng.uniform(-orbit_cfg["jitter_deg"], orbit_cfg["jitter_deg"])
    cams = []
    for az in np.linspace(lo, hi, orbit_cfg["poses"]) + offset:
        a = math.radians(az)
        eye = (orbit_cfg["distance"] * math.sin(a), orbit_cfg["height"],
               orbit_cfg["distance"] * math.cos(a))
        cams.append(camera(width, height, eye))
    return cams


def mem_dims(uri: str):
    """((X, Y, Z), brick) of a ``mem://#X,Y,Z,brick[?...]`` volume."""
    x, y, z, brick = (int(v) for v in uri.split("#", 1)[1].split("?", 1)[0].split(",")[:4])
    return (x, y, z), brick


def gradient_store(dims, phase: float, device) -> torch.Tensor:
    """The ``pattern=gradient`` field of a ``mem://`` volume at its finest
    level, (Z, Y, X): 0.5 + 0.5·sin(2π(x/X + 0.7·y/Y + 1.3·z/Z) + phase),
    quantised to uint8 as the data source stores it and normalised by
    the uint8 range, as the store the renderer assembles holds it."""
    nz, ny, nx = dims
    f32 = torch.float32
    x = torch.arange(nx, dtype=f32, device=device)[None, None, :] / nx
    y = torch.arange(ny, dtype=f32, device=device)[None, :, None] / ny
    z = torch.arange(nz, dtype=f32, device=device)[:, None, None] / nz
    field = 0.5 + 0.5 * torch.sin(2 * math.pi * (x + 0.7 * y + 1.3 * z) + phase)
    return (field * 255.0).to(torch.uint8).to(f32) / 255.0


def smooth_volume(n: int, seed: int, device, blobs: int = 6) -> torch.Tensor:
    """A smooth (n, n, n) f32 density in [0, 1]: the sum of ``blobs``
    Gaussian blobs whose centres, widths and heights are drawn from
    ``seed``, normalised by its max (the field of the reference's inverse
    rendering demo)."""
    rng = np.random.default_rng(seed)
    g = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
    x, y, z = g[None, None, :], g[None, :, None], g[:, None, None]
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for _ in range(blobs):
        c = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        s = rng.uniform(0.15, 0.4)
        a = rng.uniform(0.4, 1.0)
        r2 = (x - float(c[0])) ** 2 + (y - float(c[1])) ** 2 + (z - float(c[2])) ** 2
        vol += a * torch.exp(-r2 / (2 * s * s))
    return torch.clamp(vol / vol.max(), 0.0, 1.0)
