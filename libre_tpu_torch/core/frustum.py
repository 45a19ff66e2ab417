"""View frustum: plane extraction, culling, projection limits.

Replaces the reference's vmmlib wrapper (livre/core/render/Frustum.{h,cpp}).
Matrices use the standard OpenGL math convention with column vectors:
``clip = P @ MV @ world`` (the reference stores vmmlib matrices column-major
from the same arrays, so numeric golden tests agree).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def perspective(fovy_deg: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Standard OpenGL perspective projection matrix."""
    f = 1.0 / np.tan(np.deg2rad(fovy_deg) / 2.0)
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def look_at(eye, center, up) -> np.ndarray:
    """Standard right-handed lookAt modelview matrix."""
    eye = np.asarray(eye, np.float64)
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m.astype(np.float32)


def extract_planes(mvp: np.ndarray) -> np.ndarray:
    """Gribb-Hartmann frustum planes from a composite MVP matrix.

    Returns (6, 4) [left, right, bottom, top, near, far]; each plane
    ``(nx, ny, nz, d)`` has a unit normal pointing *into* the frustum, so
    ``dot(n, p) + d >= 0`` for points inside (vmmlib FrustumCuller
    convention used by SelectVisibles.cpp:62 and ClipPlanes.cpp:95-99).
    """
    m = np.asarray(mvp, dtype=np.float32)
    rows = [
        m[3] + m[0],  # left
        m[3] - m[0],  # right
        m[3] + m[1],  # bottom
        m[3] - m[1],  # top
        m[3] + m[2],  # near
        m[3] - m[2],  # far
    ]
    planes = np.stack(rows)
    norms = np.sqrt(np.sum(planes[:, :3] ** 2, axis=1, keepdims=True, dtype=np.float32))
    return (planes / norms).astype(np.float32)


class Frustum:
    """View frustum (reference: livre/core/render/Frustum.h:37-105)."""

    def __init__(self, modelview: np.ndarray, projection: np.ndarray):
        # All frustum math is float32 with the reference's operation order:
        # the golden LOD-selection values sit on float32 rounding boundaries
        # (tests/lib/lodSelection.cpp), so wider precision changes results.
        self.mv = np.asarray(modelview, dtype=np.float32).reshape(4, 4)
        self.proj = np.asarray(projection, dtype=np.float32).reshape(4, 4)
        self.inv_mv = np.linalg.inv(self.mv.astype(np.float64)).astype(np.float32)
        self.inv_proj = np.linalg.inv(self.proj.astype(np.float64)).astype(np.float32)
        self.mvp = (self.proj @ self.mv).astype(np.float32)
        self.planes = extract_planes(self.mvp)
        self._plane_mat = np.stack(self.planes).astype(np.float32)
        self._plane_abs = np.abs(self._plane_mat[:, :3])

        # Projection limits (vmmlib frustum(projection) extraction, used by
        # Frustum::nearPlane()/top()/bottom() in SelectVisibles.cpp:54-64).
        p = self.proj
        one = np.float32(1.0)
        self.near = p[2, 3] / (p[2, 2] - one)
        self.far = p[2, 3] / (p[2, 2] + one)
        self.bottom = self.near * (p[1, 2] - one) / p[1, 1]
        self.top = self.near * (p[1, 2] + one) / p[1, 1]
        self.left = self.near * (p[0, 2] - one) / p[0, 0]
        self.right = self.near * (p[0, 2] + one) / p[0, 0]

        # Eye position and view direction from the inverse modelview
        # (Frustum.cpp:37-42; note the reference takes +column 2, the
        # *backward* axis in GL convention).
        self.eye_pos = self.inv_mv[:3, 3].copy()
        self.view_dir = self.inv_mv[:3, 2].copy()

    @property
    def near_plane(self) -> np.ndarray:
        """Normalized near plane (nx, ny, nz, d)."""
        return self.planes[4]

    def is_in_frustum(self, box_min, box_max) -> bool:
        """Conservative AABB-vs-frustum test (center/extent per plane).

        All six planes evaluated in one stacked matvec — this runs once
        per octree node in the selection DFS, where per-plane numpy
        dispatch overhead dominated the engine's host frame time."""
        box_min = np.asarray(box_min, np.float32)
        box_max = np.asarray(box_max, np.float32)
        center = (box_min + box_max) * np.float32(0.5)
        extent = (box_max - box_min) * np.float32(0.5)
        pm = self._plane_mat  # (6, 4), rows [n | d]
        d = pm[:, :3] @ center + pm[:, 3]
        n = self._plane_abs @ extent
        return not bool(np.any(d + n <= 0))

    def __eq__(self, other) -> bool:
        return isinstance(other, Frustum) and np.allclose(self.mv, other.mv) and np.allclose(
            self.proj, other.proj
        )


def compute_near_far_corners(
    box_min, box_max, plane: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Corners of an AABB with minimal / maximal signed distance to a plane.

    Equivalent of Boxf::computeNearFar used in SelectVisibles.cpp:82.
    """
    box_min = np.asarray(box_min, np.float32)
    box_max = np.asarray(box_max, np.float32)
    normal = plane[:3]
    near = np.where(normal >= 0, box_min, box_max)
    far = np.where(normal >= 0, box_max, box_min)
    return near, far
