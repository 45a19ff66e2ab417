"""Spatial realization of an octree node: voxel box + world-space AABB.

Reference: livre/core/data/LODNode.{h,cpp} and the default regular-grid
placement DataSourcePlugin::internalNodeToLODNode
(livre/core/data/DataSourcePlugin.cpp:55-81): node world boxes live in
``[-world_size/2, world_size/2)`` normalized coordinates, scaled by the
*largest* per-axis block count of the node's level so anisotropic volumes
keep their aspect ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from libre_tpu_torch.core.nodeid import NodeId
from libre_tpu_torch.core.volume_info import VolumeInformation


@dataclasses.dataclass(frozen=True)
class LODNode:
    """A node's spatial data (LODNode.h:35-124)."""

    node_id: NodeId
    block_size: Tuple[int, int, int]  # interior voxels (no padding)
    world_box_min: Tuple[float, float, float]
    world_box_max: Tuple[float, float, float]

    @property
    def level(self) -> int:
        return self.node_id.level

    @property
    def voxel_box(self) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
        """Voxel extent at this node's level resolution (LODNode.cpp:63-67)."""
        pos = self.node_id.position
        lo = tuple(p * b for p, b in zip(pos, self.block_size))
        hi = tuple(l + b for l, b in zip(lo, self.block_size))
        return lo, hi

    @property
    def world_size(self) -> np.ndarray:
        return np.asarray(self.world_box_max, np.float32) - np.asarray(
            self.world_box_min, np.float32
        )

    def world_space_per_voxel(self) -> np.ndarray:
        """Per-axis world extent of one voxel at this node's resolution."""
        return self.world_size / np.asarray(self.block_size, np.float32)

    def is_valid(self) -> bool:
        return self.node_id.is_valid()


def regular_lod_node(node_id: NodeId, info: VolumeInformation) -> LODNode:
    """Default regular-grid node placement (DataSourcePlugin.cpp:55-81).

    World box = block index box normalized by the *largest* per-axis brick
    count of the level, then centered by subtracting world_size/2.
    """
    level = node_id.level
    bricks_in_level = info.root_node.block_size(level)
    # Float32 like the reference (vmmlib Vector3f) — golden LOD tests are
    # sensitive to rounding here.
    denom = np.float32(max(bricks_in_level))
    pos = np.asarray(node_id.position, np.float32)
    box_min = pos / denom
    box_max = (pos + np.float32(1.0)) / denom
    half = np.asarray(info.world_size, np.float32) * np.float32(0.5)
    return LODNode(
        node_id=node_id,
        block_size=info.block_size,
        world_box_min=tuple((box_min - half).astype(float)),
        world_box_max=tuple((box_max - half).astype(float)),
    )
