"""Procedural in-memory data source: ``mem://#X,Y,Z,block[?key=value...]``.

Reference: datasources/memory/MemoryDataSource.cpp.  Each brick is filled
with a constant derived from a hash of its NodeId plus a time-dependent
sine — deterministic fixtures for tests and benchmarks.  Query options:

  sparsity=f     fraction of voxels keeping the value (random zeros)
  datatype=t     uint8|uint16|uint32|int8|int16|int32|float  (default uint8)
  pattern=p      'constant' (reference parity, default) or 'gradient'
                 (a smooth per-voxel field, useful for trilinear and
                 gradient tests where constant bricks are degenerate)
"""

from __future__ import annotations

import numpy as np

from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.volume_info import (
    DataType,
    FULL_FRAME_RANGE,
    VolumeInformation,
    fill_regular_volume_info,
)
from libre_tpu_torch.data.datasource import DataSourcePlugin, ParsedURI, register_datasource


def node_value(node_id_int: int, time_step: int) -> float:
    """Per-node constant: XOR of the low 4 id bytes + 16 + time sine
    (MemoryDataSource.cpp:48-58)."""
    b = node_id_int.to_bytes(8, "little")
    return (b[0] ^ b[1] ^ b[2] ^ b[3]) + 16 + 127 * np.sin((time_step + 1) / 200.0)


@register_datasource
class MemoryDataSource(DataSourcePlugin):
    """Procedural volume with a regular flat octree (MemoryDataSource.cpp:74-162)."""

    def __init__(self, uri: ParsedURI):
        super().__init__()
        info = self.volume_info
        info.overlap = (4, 4, 4)
        info.data_type = DataType.from_string(uri.query.get("datatype", "uint8"))
        self._sparsity = float(uri.query.get("sparsity", 1.0))
        self._pattern = uri.query.get("pattern", "constant")

        params = [p for p in uri.fragment.split(",") if p]
        if len(params) < 4:
            info.voxels = (4096, 4096, 4096)
            info.maximum_block_size = tuple(32 + 2 * o for o in info.overlap)
        else:
            info.voxels = tuple(int(p) for p in params[:3])
            block = int(params[3])
            info.maximum_block_size = tuple(block + 2 * o for o in info.overlap)

        info.frame_range = FULL_FRAME_RANGE
        fill_regular_volume_info(info)

    @staticmethod
    def handles(uri: ParsedURI) -> bool:
        return uri.scheme == "mem"

    def get_data(self, lod_node: LODNode) -> np.ndarray:
        info = self.volume_info
        overlap = info.overlap
        padded = tuple(b + 2 * o for b, o in zip(lod_node.block_size, overlap))
        shape_zyx = (padded[2], padded[1], padded[0])
        dtype = info.data_type.numpy_dtype

        node_id = lod_node.node_id
        value = node_value(node_id.id, node_id.time_step)

        if self._pattern == "gradient":
            # Smooth spatially varying field in *global* coordinates so
            # neighbouring bricks agree on their shared ghost voxels.
            vx0, _ = lod_node.voxel_box
            z = np.arange(shape_zyx[0], dtype=np.float32) - overlap[2] + vx0[2]
            y = np.arange(shape_zyx[1], dtype=np.float32) - overlap[1] + vx0[1]
            x = np.arange(shape_zyx[2], dtype=np.float32) - overlap[0] + vx0[0]
            zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")
            level_size = np.asarray(info.root_node.block_size(node_id.level)) * np.asarray(
                lod_node.block_size
            )
            phase = (
                xx / max(level_size[0], 1)
                + 0.7 * yy / max(level_size[1], 1)
                + 1.3 * zz / max(level_size[2], 1)
            )
            field = 0.5 + 0.5 * np.sin(2 * np.pi * phase + 0.01 * value)
            if info.data_type.is_float:
                return field.astype(dtype)
            lo, hi = info.data_type.default_range
            return (lo + field * (hi - lo)).astype(dtype)

        data = np.full(shape_zyx, value, dtype=dtype)
        if self._sparsity < 1.0:
            rng = np.random.default_rng(node_id.id & 0xFFFFFFFF)
            keep = rng.random(shape_zyx) < self._sparsity
            data = np.where(keep, data, np.zeros((), dtype=dtype))
        return data
