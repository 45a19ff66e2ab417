"""Shared render types and constants (numpy; ``libre_tpu.ops.reference``).

The constants and types the bricked path needs from the JAX package's
reference marcher, copied so that the port imports no jax: the early-exit
threshold and alpha clamp of fragRaycast.glsl:104-117, the GL camera
triple, the static marching parameters and the Nyquist sample count.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

EARLY_EXIT = 0.999
ALPHA_CLAMP = 1.0 - 1.0 / 256.0
MAX_SAMPLES_PER_RAY = 32  # opacity-correction reference count (GLRaycastRenderer.cpp:75)
MIN_SAMPLES_PER_RAY = 512


class Camera(NamedTuple):
    """GL-style camera: modelview/projection pair plus viewport."""

    inv_proj: np.ndarray  # (4, 4)
    inv_mv: np.ndarray  # (4, 4)
    viewport: Tuple[int, int, int, int]  # (x, y, w, h)
    near: float  # near-plane distance (Frustum::nearPlane())


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static marching parameters (RendererParameters defaults,
    rendererParameters.fbs:3-12): the fields the bricked path reads.
    The exact marcher's (filter mode, samples per pixel, per-brick step
    bounds) come with it (ROADMAP M7)."""

    n_samples_per_ray: int = MIN_SAMPLES_PER_RAY
    max_samples_per_ray: int = MAX_SAMPLES_PER_RAY
    data_source_range: Tuple[float, float] = (0.0, 255.0)
    early_exit: float = EARLY_EXIT


def nyquist_samples_per_ray(
    voxels: Tuple[int, int, int], tree_depth: int, max_rendered_level: int
) -> int:
    """Auto sample count: Nyquist from the finest rendered LOD, min 512
    (GLRaycastRenderer.cpp:232-248)."""
    max_voxel_dim = float(max(voxels))
    max_voxels_at_lod = max_voxel_dim / float(1 << (tree_depth - max_rendered_level - 1))
    return int(max(max_voxels_at_lod, MIN_SAMPLES_PER_RAY))
