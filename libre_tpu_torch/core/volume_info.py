"""Dataset metadata: data types, volume information, regular-octree setup.

Reference: livre/core/data/VolumeInformation.h:30-112 and the implicit flat
octree construction in livre/core/data/DataSourcePlugin.cpp:83-109.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple

import numpy as np

from libre_tpu_torch.core.nodeid import RootNode

FULL_FRAME_RANGE = (0, 2**31 - 1)
LATEST_FRAME = 2**31 - 1


class DataType(enum.Enum):
    """Voxel data types (VolumeInformation.h:30-40)."""

    UINT8 = "uint8"
    UINT16 = "uint16"
    UINT32 = "uint32"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    FLOAT = "float32"
    UNDEFINED = "undefined"

    @property
    def numpy_dtype(self) -> np.dtype:
        if self is DataType.UNDEFINED:
            raise ValueError("undefined data type")
        return np.dtype(self.value)

    @property
    def bytes_per_voxel(self) -> int:
        return self.numpy_dtype.itemsize

    @property
    def is_signed(self) -> bool:
        return self in (DataType.INT8, DataType.INT16, DataType.INT32)

    @property
    def is_float(self) -> bool:
        return self is DataType.FLOAT

    @property
    def default_range(self) -> Tuple[float, float]:
        """Full representable range, used to normalize densities for the TF.

        Integer types span the dtype range (HistogramObject.cpp:36-80 uses the
        dtype limits; the renderer normalizes by ``dataSourceRange``); float
        data must provide an explicit range.
        """
        if self.is_float:
            return (0.0, 1.0)
        info = np.iinfo(self.numpy_dtype)
        return (float(info.min), float(info.max))

    @classmethod
    def from_string(cls, s: str) -> "DataType":
        aliases = {
            "char": cls.INT8,
            "short": cls.INT16,
            "int": cls.INT32,
            "float": cls.FLOAT,
            "float32": cls.FLOAT,
        }
        if s in aliases:
            return aliases[s]
        for member in cls:
            if member.value == s:
                return member
        raise ValueError(f"unknown data type: {s!r}")


@dataclasses.dataclass
class VolumeInformation:
    """Dataset metadata (VolumeInformation.h:43-112).

    World coordinates: the volume is centered at the origin and the longest
    axis spans 1 world unit, i.e. world box = ``[-world_size/2, world_size/2]``
    (GLRaycastRenderer.cpp:275-283 derives the global AABB this way).
    """

    voxels: Tuple[int, int, int] = (0, 0, 0)
    maximum_block_size: Tuple[int, int, int] = (0, 0, 0)
    overlap: Tuple[int, int, int] = (0, 0, 0)
    data_type: DataType = DataType.UINT8
    component_count: int = 1
    world_size: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    world_space_per_voxel: float = 0.0
    root_node: RootNode = dataclasses.field(default_factory=RootNode)
    frame_range: Tuple[int, int] = FULL_FRAME_RANGE
    big_endian: bool = False
    description: str = ""
    meter_to_data_unit_ratio: float = 1.0
    data_to_livre_transform: Optional[np.ndarray] = None

    @property
    def bytes_per_voxel(self) -> int:
        return self.data_type.bytes_per_voxel

    @property
    def block_size(self) -> Tuple[int, int, int]:
        """Interior block size (without ghost/overlap voxels)."""
        return tuple(m - 2 * o for m, o in zip(self.maximum_block_size, self.overlap))

    @property
    def world_box(self) -> Tuple[np.ndarray, np.ndarray]:
        half = np.asarray(self.world_size, dtype=np.float32) * 0.5
        return -half, half

    def padded_brick_bytes(self) -> int:
        n = int(np.prod(self.maximum_block_size))
        return n * self.component_count * self.bytes_per_voxel


def fill_regular_volume_info(info: VolumeInformation) -> VolumeInformation:
    """Build the implicit flat octree for a regular grid.

    Math kept identical to DataSourcePlugin.cpp:83-109 (fillRegularVolumeInfo)
    so golden-value tests from the reference carry over: tree depth is the
    *minimum* per-axis level count (so every level is fully populated along
    the shortest axis) and the root block count covers the coarsest level.
    """
    voxels = tuple(int(v) for v in info.voxels)
    info.world_space_per_voxel = 1.0 / float(max(voxels))
    info.world_size = tuple(v * info.world_space_per_voxel for v in voxels)

    block = info.block_size
    if any(b <= 0 for b in block):
        raise ValueError(f"non-positive interior block size {block}")
    num_blocks = [math.ceil(v / b) for v, b in zip(voxels, block)]
    lod_levels = [math.ceil(math.log2(n)) if n > 1 else 0 for n in num_blocks]
    depth = min(lod_levels)
    root_blocks = [math.ceil(float(v >> depth) / b) for v, b in zip(voxels, block)]
    info.root_node = RootNode(depth + 1, root_blocks)
    return info
