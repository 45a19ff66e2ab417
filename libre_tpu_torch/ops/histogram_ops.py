"""Histogram subsystem: per-brick histograms + merge
(``libre_tpu.ops.histogram_ops``).

Reference: livre/core/data/Histogram.{h,cpp} (1-D bin vector with a data
range, merged via += which requires compatible ranges, min/max index,
ratio) and livre/lib/cache/HistogramObject.cpp:36-119 (per-brick binning
over interior voxels — padding excluded; integer dtypes use the full dtype
range, float data scans its min/max first; uniform-data fast path).

The 256-bin count runs on the given torch device (``torch.bincount``); the
normalisation stays on the host in float64, cast to f32 before the bin
index is taken in f32, as the reference rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.core.volume_info import DataType

DEFAULT_BINS = 256


@dataclasses.dataclass
class Histogram:
    """Bins + the data range they span (Histogram.h:34-104)."""

    bins: np.ndarray  # (n_bins,) uint64
    min_value: float
    max_value: float

    def __iadd__(self, other: "Histogram") -> "Histogram":
        if (self.min_value, self.max_value) != (other.min_value, other.max_value):
            raise ValueError(
                f"merging histograms with incompatible ranges "
                f"[{self.min_value}, {self.max_value}] vs "
                f"[{other.min_value}, {other.max_value}]"
            )
        if len(self.bins) != len(other.bins):
            raise ValueError("merging histograms with different bin counts")
        self.bins = self.bins + other.bins
        return self

    def __add__(self, other: "Histogram") -> "Histogram":
        out = Histogram(self.bins.copy(), self.min_value, self.max_value)
        out += other
        return out

    @property
    def sum(self) -> int:
        return int(self.bins.sum())

    def is_empty(self) -> bool:
        return self.sum == 0

    @property
    def min_index(self) -> int:
        nz = np.nonzero(self.bins)[0]
        return int(nz[0]) if len(nz) else 0

    @property
    def max_index(self) -> int:
        nz = np.nonzero(self.bins)[0]
        return int(nz[-1]) if len(nz) else 0

    def get_ratio(self, index: int) -> float:
        s = self.sum
        return float(self.bins[index]) / s if s else 0.0

    def get_range(self) -> Tuple[float, float]:
        return (self.min_value, self.max_value)


def _bincount_256(values01: torch.Tensor) -> torch.Tensor:
    """Count f32 values in [0, 1] into 256 bins on their device: the bin
    is the f32 product with 256, truncated, clipped to [0, 255]."""
    idx = (values01 * DEFAULT_BINS).to(torch.int32).clamp_(0, DEFAULT_BINS - 1)
    return torch.bincount(idx.reshape(-1), minlength=DEFAULT_BINS)


def compute_brick_histogram(
    padded_brick_zyx: np.ndarray,
    overlap: Tuple[int, int, int],
    data_type: DataType,
    data_range: Optional[Tuple[float, float]] = None,
    n_bins: int = DEFAULT_BINS,
    device="cuda",
) -> Histogram:
    """Per-brick histogram over interior (padding-excluded) voxels
    (HistogramObject.cpp:36-119); the 256-bin count runs on ``device``."""
    ox, oy, oz = overlap
    interior = padded_brick_zyx
    if oz:
        interior = interior[oz:-oz]
    if oy:
        interior = interior[:, oy:-oy]
    if ox:
        interior = interior[:, :, ox:-ox]

    if data_range is not None:
        lo, hi = data_range
    elif data_type.is_float:
        lo = float(interior.min())
        hi = float(interior.max())
    else:
        lo, hi = data_type.default_range
        hi = hi + 1.0  # integer bins cover [min, max] inclusive

    if hi <= lo:  # uniform data fast path (HistogramObject.cpp:58-66)
        bins = np.zeros(n_bins, np.uint64)
        bins[0] = interior.size
        return Histogram(bins, lo, lo)

    vals = np.asarray(interior, np.float64)
    norm = (vals - lo) / (hi - lo)
    if n_bins == DEFAULT_BINS:
        values01 = torch.from_numpy(norm.astype(np.float32)).to(device)
        bins = _bincount_256(values01).cpu().numpy().astype(np.uint64)
    else:
        idx = np.clip((norm * n_bins).astype(np.int64), 0, n_bins - 1)
        bins = np.bincount(idx.reshape(-1), minlength=n_bins).astype(np.uint64)
    return Histogram(bins, lo, hi)
