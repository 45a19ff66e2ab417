"""LOD selection: pick the set of octree bricks to render for a view.

The screen-space-error (SSE) driven DFS of the reference
(livre/core/render/SelectVisibles.cpp:52-142): descend the octree, cull
nodes outside the frustum or clipped; a node is selected when its projected
voxel footprint ``pixelPerVoxel * n / (n + distance)`` drops at or below the
SSE threshold (coarser-than-a-pixel ⇒ good enough), clamped by min/max LOD
and the tree depth.  The optional ``range`` filter keeps only an index
interval of the visible list — the sort-last (DB) work-decomposition hook.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from libre_tpu_torch.core.clip_planes import ClipPlanes
from libre_tpu_torch.core.frustum import Frustum, compute_near_far_corners
from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.nodeid import NodeId
from libre_tpu_torch.core.visitor import NodeVisitor, VisitState, dfs_traverse


class SelectVisibles(NodeVisitor):
    """Visitor implementing the SSE LOD selection (SelectVisibles.cpp:32-142)."""

    def __init__(
        self,
        datasource,
        frustum: Frustum,
        window_height: int,
        screen_space_error: float,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        data_range: Tuple[float, float] = (0.0, 1.0),
        clip_planes: Optional[ClipPlanes] = None,
    ):
        self._datasource = datasource
        self._frustum = frustum
        self._window_height = int(window_height)
        self._sse = float(screen_space_error)
        self._min_lod = int(min_lod)
        self._max_lod = int(max_lod)
        self._range = data_range
        # No explicit clip set ⇒ the reference's default unit-box planes,
        # which cannot clip any in-volume brick (world boxes are
        # normalized to [-0.5, 0.5]) — skip the 6-plane test per node.
        self._skip_clip = clip_planes is None or not clip_planes.planes
        self._clip_planes = clip_planes if clip_planes is not None else ClipPlanes()
        self.visibles: List[NodeId] = []

    # SelectVisibles.cpp:52-68.  Float32 with the reference's op order: the
    # golden expectations sit exactly on f32 rounding boundaries.
    def _is_lod_visible(self, world_coord: np.ndarray, world_space_per_voxel) -> bool:
        f = self._frustum
        world_space_per_pixel = (f.top - f.bottom) / np.float32(self._window_height)
        pixel_per_voxel = np.float32(world_space_per_voxel) / world_space_per_pixel
        h = np.append(world_coord, np.float32(1.0)).astype(np.float32)
        distance = np.abs(np.float32(f.near_plane @ h))
        n = f.near
        pixel_per_voxel_in_distance = pixel_per_voxel * n / (n + distance)
        return bool(pixel_per_voxel_in_distance <= np.float32(self._sse))

    def visit_pre(self) -> None:
        self.visibles = []

    def visit(self, node_id: NodeId, state: VisitState) -> None:
        lod_node: LODNode = self._datasource.get_node(node_id)
        if min(lod_node.block_size) <= 0:
            # Invalid node — e.g. a child outside a non-octree brick
            # grid (UVF subsets, UVFDataSource.cpp:311-318): cull and
            # do not descend (its children are invalid too).
            state.visit_child = False
            return
        wmin = np.asarray(lod_node.world_box_min, np.float32)
        wmax = np.asarray(lod_node.world_box_max, np.float32)

        if not self._frustum.is_in_frustum(wmin, wmax) or (
            not self._skip_clip
            and self._clip_planes.is_clipped(wmin, wmax)
        ):
            state.visit_child = False
            return

        near_plane = self._frustum.near_plane
        vmin, vmax = compute_near_far_corners(wmin, wmax, near_plane)
        # Box intersects the near plane → evaluate at the eye's near-plane
        # point instead (SelectVisibles.cpp:91-96).
        if (
            float(near_plane @ np.append(vmin, 1.0)) < 0
            or float(near_plane @ np.append(vmax, 1.0)) < 0
        ):
            vmin = self._frustum.eye_pos - self._frustum.view_dir * self._frustum.near

        world_space_per_voxel = np.float32(np.min(lod_node.world_space_per_voxel()))
        lod_visible = self._is_lod_visible(vmin, world_space_per_voxel)

        depth = self._datasource.volume_info.root_node.depth
        level = lod_node.level
        lod_visible = (
            (lod_visible and level >= self._min_lod)
            or level == self._max_lod
            or level == depth - 1
        )

        if lod_visible:
            self.visibles.append(node_id)
        state.visit_child = not lod_visible

    # Sort-last index-interval split of the visible list
    # (SelectVisibles.cpp:120-142).
    def visit_post(self) -> None:
        lo, hi = self._range
        n = len(self.visibles)
        start = int(lo * n)
        end = int(hi * n)
        self.visibles = [v for i, v in enumerate(self.visibles) if start <= i < end]


def select_visibles(
    datasource,
    frustum: Frustum,
    window_height: int,
    screen_space_error: float,
    min_lod: int = 0,
    max_lod: int = (1 << 4) - 1,
    data_range: Tuple[float, float] = (0.0, 1.0),
    clip_planes: Optional[ClipPlanes] = None,
    time_step: int = 0,
) -> List[NodeId]:
    """Run the LOD-selection DFS over the datasource's octree."""
    visitor = SelectVisibles(
        datasource,
        frustum,
        window_height,
        screen_space_error,
        min_lod,
        max_lod,
        data_range,
        clip_planes,
    )
    dfs_traverse(datasource.volume_info.root_node, visitor, time_step)
    return visitor.visibles
