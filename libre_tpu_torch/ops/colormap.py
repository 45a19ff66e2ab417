"""Control-point colormap model — the TransferFunctionEditor core.

Reference: livreGUI edits a lexis::render::ColorMap — four channels of
(x, value) control points dragged as HoverPoints curves
(apps/livreGUI/transferFunctionEditor/TransferFunctionEditor.cpp:95-188,
HoverPoints.cpp) — publishes it over ZeroEQ, and saves/loads it as
*.lba (ascii) / *.lbb (binary) lunchbox serializations
(TransferFunctionEditor.cpp:191-247).  The renderer samples the control
points into the 256-entry RGBA table bound as the TF texture.

This module is that model without the Qt: sorted per-channel control
points, piecewise-linear sampling to a table, HoverPoints-style editing
operations (add/move/remove with locked endpoints), and .lba/.lbb file
IO.  The serialized layouts are this framework's own (the reference's
binary layout is ZeroBuf-internal and not a documented format); the
semantics — control points round-tripping by channel — match.

The sampled table feeds ops/transfer_function.lookup and is the
differentiable TF parameter everywhere else in the framework.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

CHANNELS = ("red", "green", "blue", "alpha")
_LBB_MAGIC = b"LBTF"
_LBB_VERSION = 1


def _f32(v: float) -> float:
    """Canonicalize coordinates to float32 so .lbb (packed f32) and .lba
    round-trip to equal ColorMaps."""
    return float(np.float32(v))


class ColorMap:
    """Four channels of sorted (x, y) control points, x and y in [0, 1]."""

    def __init__(self, points: Dict[str, List[Tuple[float, float]]] = None):
        self.points: Dict[str, List[Tuple[float, float]]] = {
            ch: [] for ch in CHANNELS
        }
        if points:
            for ch, pts in points.items():
                if ch not in self.points:
                    raise ValueError(f"unknown channel {ch!r}")
                self.points[ch] = sorted((_f32(x), _f32(y)) for x, y in pts)

    # ------------------------------------------------------------ editing
    def add_point(self, channel: str, x: float, y: float) -> int:
        """Insert a control point, keeping x order; returns its index."""
        x = _f32(min(max(float(x), 0.0), 1.0))
        y = _f32(min(max(float(y), 0.0), 1.0))
        pts = self.points[channel]
        pts.append((x, y))
        pts.sort()
        return pts.index((x, y))

    def move_point(self, channel: str, index: int, x: float, y: float):
        """HoverPoints drag: endpoints stay pinned to x=0 / x=1
        (HoverPoints.cpp lock semantics); interior x clamps between
        neighbours so order is preserved."""
        pts = self.points[channel]
        y = min(max(float(y), 0.0), 1.0)
        if index == 0:
            x = pts[0][0] if len(pts) else 0.0
        elif index == len(pts) - 1:
            x = pts[-1][0]
        else:
            lo = pts[index - 1][0]
            hi = pts[index + 1][0]
            x = min(max(float(x), lo), hi)
        pts[index] = (_f32(x), _f32(y))

    def remove_point(self, channel: str, index: int):
        """Endpoints cannot be removed (HoverPoints lock)."""
        pts = self.points[channel]
        if index in (0, len(pts) - 1):
            raise ValueError("endpoint control points are locked")
        del pts[index]

    # ----------------------------------------------------------- sampling
    def sample(self, size: int = 256) -> np.ndarray:
        """Piecewise-linear per-channel evaluation → (size, 4) float32.
        Empty channel ⇒ zeros; values clamp outside the point range."""
        xs = np.linspace(0.0, 1.0, size, dtype=np.float32)
        out = np.zeros((size, 4), np.float32)
        for i, ch in enumerate(CHANNELS):
            pts = self.points[ch]
            if not pts:
                continue
            px = np.asarray([p[0] for p in pts], np.float32)
            py = np.asarray([p[1] for p in pts], np.float32)
            out[:, i] = np.interp(xs, px, py)
        return out

    # ----------------------------------------------------------- file IO
    def save_lba(self, path: str) -> None:
        """Ascii save (the reference's lunchbox::saveAscii role)."""
        with open(path, "w") as f:
            json.dump({"channels": self.points}, f, indent=1)

    @classmethod
    def load_lba(cls, path: str) -> "ColorMap":
        with open(path) as f:
            data = json.load(f)
        return cls(data["channels"])

    def save_lbb(self, path: str) -> None:
        """Binary save (the reference's lunchbox::saveBinary role):
        magic, version, then per channel a u32 count + f32 (x, y) pairs."""
        with open(path, "wb") as f:
            f.write(_LBB_MAGIC + struct.pack("<I", _LBB_VERSION))
            for ch in CHANNELS:
                pts = self.points[ch]
                f.write(struct.pack("<I", len(pts)))
                for x, y in pts:
                    f.write(struct.pack("<ff", x, y))

    @classmethod
    def load_lbb(cls, path: str) -> "ColorMap":
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != _LBB_MAGIC:
            raise ValueError(f"{path}: not a .lbb colormap")
        (version,) = struct.unpack_from("<I", raw, 4)
        if version != _LBB_VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        off = 8
        points = {}
        for ch in CHANNELS:
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            pts = []
            for _ in range(n):
                x, y = struct.unpack_from("<ff", raw, off)
                off += 8
                pts.append((x, y))
            points[ch] = pts
        return cls(points)

    # ----------------------------------------------------------- defaults
    @classmethod
    def default(cls) -> "ColorMap":
        """Control-point form of the default table
        (transfer_function.default_color_map)."""
        from libre_tpu_torch.ops.transfer_function import default_color_map

        return cls.from_table(default_color_map(), n_points=17)

    @classmethod
    def from_table(cls, table: np.ndarray, n_points: int = 17) -> "ColorMap":
        """Fit control points to a sampled (N, 4) table by uniform
        subsampling (round-trips exactly for piecewise-linear tables with
        knots on the grid)."""
        table = np.asarray(table, np.float32)
        n = table.shape[0]
        idx = np.linspace(0, n - 1, n_points).round().astype(int)
        xs = idx / float(n - 1)
        points = {}
        for i, ch in enumerate(CHANNELS):
            points[ch] = [(float(x), float(table[j, i])) for x, j in zip(xs, idx)]
        return cls(points)

    def __eq__(self, other) -> bool:
        return isinstance(other, ColorMap) and self.points == other.points


def load(path: str, size: int = 256) -> np.ndarray:
    """Load any supported TF file (.lba/.lbb control points, .1dt table)
    → (size, 4) float32 table."""
    from libre_tpu_torch.ops import transfer_function as tf_ops

    if path.endswith(".lba"):
        return ColorMap.load_lba(path).sample(size)
    if path.endswith(".lbb"):
        return ColorMap.load_lbb(path).sample(size)
    if path.endswith(".1dt"):
        return tf_ops.load_1dt(path)
    raise ValueError(f"unknown transfer-function format: {path}")
