"""World-space clip planes (≤6), defaulting to the unit box.

Reference: livre/core/render/ClipPlanes.{h,cpp}.  A plane is (nx, ny, nz, d)
with the *kept* half-space satisfying ``dot(n, p) + d >= 0``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

_DEFAULT_NORMALS = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ],
    dtype=np.float32,
)

MAX_PLANES = 6


class ClipPlanes:
    """Set of up to 6 clip planes (ClipPlanes.cpp:60-105).

    The default (``reset()``) is the 6 faces of the axis-aligned unit box
    ``[-0.5, 0.5]^3`` (normals ±e_i, d = 0.5), i.e. nothing inside the
    normalized volume world box is clipped.
    """

    def __init__(self, planes: Sequence[Sequence[float]] | None = None):
        if planes is None:
            self.reset()
        else:
            self.planes = [np.asarray(p, np.float32) for p in planes]

    def reset(self) -> None:
        self.planes: List[np.ndarray] = [
            np.concatenate([n, np.float32([0.5])]).astype(np.float32)
            for n in _DEFAULT_NORMALS
        ]

    def clear(self) -> None:
        self.planes = []

    def is_empty(self) -> bool:
        return len(self.planes) == 0

    def is_clipped(self, box_min, box_max) -> bool:
        """Conservative AABB test (ClipPlanes.cpp:82-105): clipped when the
        box is entirely in the discarded half-space of any plane."""
        box_min = np.asarray(box_min, np.float64)
        box_max = np.asarray(box_max, np.float64)
        middle = (box_min + box_max) * 0.5
        extent = (box_max - box_min) * 0.5
        for p in self.planes:
            d = float(p[:3] @ middle) + float(p[3])
            n = float(extent @ np.abs(p[:3]))
            if not (d - n >= 0 or d + n > 0):
                return True
        return False

    def as_array(self) -> np.ndarray:
        """(n_planes, 4) float32 array for kernels; empty → (0, 4)."""
        if not self.planes:
            return np.zeros((0, 4), np.float32)
        return np.stack(self.planes).astype(np.float32)
