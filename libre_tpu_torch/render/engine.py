"""Render engine: LOD selection → rendering set → upload → frame
(``libre_tpu.render.engine``).

Per frame, as in renderers/glRaycaster/GLRaycastPipeline.cpp:78-350:

  * ``select_visibles`` picks the LOD brick set for the view (SSE DFS);
  * bricks stream datasource → host data cache (LRU) → device atlas
    slots;
  * :meth:`render_bricked`: the rendering set is assembled into one
    density store on the device, cached across frames, and swept by the
    post-classification kernel (``ops/shearwarp_bricked.py``);
  * :meth:`render`: the exact marcher (``ops/exact.py``) walks the set
    front to back in memory-bounded passes of atlas-resident bricks,
    with the per-ray (rgb, a) carried across passes
    (GLRaycastPipeline.cpp:148-186);
  * :meth:`render_shearwarp`: one dense LOD level, classified once per
    (level, time step, axis, TF) into an RGBA plane stack, cached, and
    swept by the pre-classified kernel (``ops/shearwarp_dense.py``).

Implemented: the synchronous in-core branch of :meth:`render_bricked`,
the synchronous multipass :meth:`render` and :meth:`render_shearwarp`.
The out-of-core slab multipass and asynchronous rendering (ROADMAP M5)
and histogram collection (ROADMAP M6) raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.core.cache import LRUCache
from libre_tpu_torch.core.clip_planes import ClipPlanes
from libre_tpu_torch.core.frustum import Frustum
from libre_tpu_torch.core.nodeid import NodeId
from libre_tpu_torch.core.select_visibles import select_visibles
from libre_tpu_torch.data.datasource import DataSource
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops.atlas import BrickAtlas, atlas_capacity, torch_dtype
from libre_tpu_torch.ops.raycast import brick_boxes, ray_pack, sort_bricks_front_to_back
from libre_tpu_torch.ops.reference import (
    Camera,
    RenderParams,
    max_steps_for_bricks,
    nyquist_samples_per_ray,
)
from libre_tpu_torch.ops.transfer_function import default_color_map

MARCHERS = ("auto", "pallas", "xla")
SHEARWARP_BACKENDS = ("auto", "pallas", "jnp")


@dataclasses.dataclass
class RenderStatistics:
    """Availability counters (FrameInfo.h RenderStatistics)."""

    n_available: int = 0
    n_not_available: int = 0
    n_render_available: int = 0
    n_passes: int = 0
    rendering_done: bool = True


class _SharedByteBudget:
    """One explicit device-byte budget shared by several LRU pools.

    The engine's device memory is ``max_gpu_cache_mb`` TOTAL: the brick
    atlas takes ``ATLAS_FRACTION`` of it at init, and every derived
    device tensor (assembled density stores, classified plane stacks) is
    byte-accounted against the remainder here, evicted globally
    least-recently-used."""

    def __init__(self, budget_bytes: int):
        self.budget = int(budget_bytes)
        self.pools: List["_ByteLRU"] = []
        self.clock = 0

    @property
    def used(self) -> int:
        return sum(p.used for p in self.pools)

    def tick(self) -> int:
        self.clock += 1
        return self.clock

    def ensure(self, needed: int) -> None:
        """Evict the globally oldest entries until ``needed`` fits.

        Eviction drops the CACHE reference only: tensors still referenced
        by a caller stay alive (and uncounted) until that reference
        dies."""
        while self.used + needed > self.budget:
            oldest = None
            for p in self.pools:
                ts = p.oldest_ts()
                if ts is not None and (oldest is None or ts < oldest[0]):
                    oldest = (ts, p)
            if oldest is None:
                if needed > self.budget:
                    logging.getLogger(__name__).warning(
                        "_SharedByteBudget: single put of %d B exceeds "
                        "the %d B device budget; overshooting",
                        needed,
                        self.budget,
                    )
                break
            oldest[1].evict_oldest()


class _ByteLRU:
    """Byte-accounted LRU dict over a shared budget (key → value)."""

    def __init__(self, shared: _SharedByteBudget):
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.used = 0
        self.shared = shared
        shared.pools.append(self)

    def get(self, key):
        hit = self._d.get(key)
        if hit is None:
            return None
        self._d.move_to_end(key)
        self._d[key] = (hit[0], hit[1], self.shared.tick())
        return hit[0]

    def put(self, key, value, nbytes: int) -> None:
        if key in self._d:
            self.used -= self._d.pop(key)[1]
        self.shared.ensure(int(nbytes))
        self._d[key] = (value, int(nbytes), self.shared.tick())
        self.used += int(nbytes)

    def oldest_ts(self):
        for _k, (_v, _n, ts) in self._d.items():
            return ts
        return None

    def evict_oldest(self) -> None:
        _k, (_v, nbytes, _ts) = self._d.popitem(last=False)
        self.used -= nbytes

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)


# Share of the device budget the brick atlas preallocates.
ATLAS_FRACTION = 0.5


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RenderEngine:
    """Owns the datasource, the caches, the device atlas and the frame
    runners.

    Device accounting: ``max_gpu_cache_mb`` is the TOTAL device budget.
    The brick atlas preallocates ``ATLAS_FRACTION`` of it in the
    dataset's NATIVE dtype (livre/core/render/TexturePool.cpp:42-84);
    assembled density stores and classified plane stacks share the
    remainder under a byte-accounted LRU (_SharedByteBudget)."""

    def __init__(
        self,
        datasource: DataSource,
        max_gpu_cache_mb: int = 3072,
        max_cpu_cache_mb: int = 8192,
        filter_mode: str = "nearest",
        device="cuda",
    ):
        self.datasource = datasource
        self.device = torch.device(device)
        info = datasource.volume_info
        self.info = info
        padded = info.maximum_block_size  # (x, y, z)
        self._brick_shape_zyx = (padded[2], padded[1], padded[0])
        # The exact marcher's default filter (render with params=None).
        self.filter_mode = filter_mode
        self.atlas_dtype = torch_dtype(info.data_type.numpy_dtype)
        # Interior box of every brick inside its padded slot, in
        # normalized texture coordinates (TextureObject.cpp:79-128).
        overlap = np.asarray(info.overlap, np.float32)
        pad = np.asarray(padded, np.float32)
        self._tex_min = overlap / pad
        self._tex_max = (overlap + np.asarray(info.block_size, np.float32)) / pad

        total_budget = max_gpu_cache_mb * 2**20
        atlas_budget = max(1, int(total_budget * ATLAS_FRACTION))
        n_slots = atlas_capacity(
            atlas_budget, self._brick_shape_zyx, self.atlas_dtype
        )
        self.atlas = BrickAtlas(
            n_slots, self._brick_shape_zyx, self.atlas_dtype, self.device
        )
        self.device_budget = _SharedByteBudget(
            total_budget - n_slots * self.atlas.slot_bytes
        )

        # Host brick cache: datasource → numpy (DataCache).
        self.data_cache: LRUCache[np.ndarray] = LRUCache(
            "DataCache",
            max_cpu_cache_mb * 2**20,
            loader=self._load_brick,
        )
        # Device residency: node id → atlas slot (TextureCache).
        self.texture_cache: LRUCache[int] = LRUCache(
            "TextureCache",
            n_slots * self.atlas.slot_bytes,
            on_evict=lambda cid, slot: self.atlas.release(slot),
        )

        self.transfer_function = torch.from_numpy(default_color_map()).to(
            self.device
        )
        self.data_source_range = info.data_type.default_range

        # Derived device tensors, byte-accounted against the shared
        # device budget (LRU across both pools): classified plane stacks
        # (dense path) keyed by (level, time_step, axis, id(TF), data
        # range), and assembled density stores (bricked path) keyed by
        # (axis, set ids, time_step, data range, level).  Several entries
        # let orbiting across an axis boundary reuse instead of rebuild.
        self._classified_cache = _ByteLRU(self.device_budget)
        self._store_cache = _ByteLRU(self.device_budget)
        # Steady-state frame runners keyed by (set_key, view statics).
        self._frame_runners: Dict[tuple, swb.StoreFrameRunner] = {}

    # ------------------------------------------------------------------ IO
    def _load_brick(self, cache_id: int) -> Tuple[np.ndarray, int]:
        data = self.datasource.get_data(NodeId(cache_id))
        return data, data.nbytes

    def _upload_nodes(self, nodes: Sequence[NodeId]) -> List:
        """Batched host → atlas upload: one copy for every missing brick.
        Returns the texture-cache entries in ``nodes`` order."""
        entries = {id(n): self.texture_cache.get(n.id) for n in nodes}
        missing = [n for n in nodes if entries[id(n)] is None]
        if missing:
            self.prefetch_batch(missing)
            datas = [self.data_cache.load(n.id).value for n in missing]
            self.texture_cache.ensure_budget(
                self.atlas.slot_bytes * len(missing)
            )
            slots = [self.atlas.acquire() for _ in missing]
            try:
                self.atlas.upload_many(slots, np.stack(datas))
            except Exception:
                for s in slots:
                    self.atlas.release(s)
                raise
            for n, s in zip(missing, slots):
                e = self.texture_cache.load(
                    n.id,
                    loader=lambda cid, s=s: (s, self.atlas.slot_bytes),
                )
                if e.value != s:
                    # Another thread inserted this node first; return
                    # our pre-acquired slot to the pool.
                    self.atlas.release(s)
                entries[id(n)] = e
        return [entries[id(n)] for n in nodes]

    def prefetch_batch(self, nodes: Sequence[NodeId]) -> None:
        """Blocking batched datasource → host load of all missing bricks
        through the datasource's batch path."""
        missing = [n for n in nodes if n.id not in self.data_cache]
        if not missing:
            return
        bricks = self.datasource.get_data_batch(missing)
        for node, brick in zip(missing, bricks):
            self.data_cache.load(
                node.id, loader=lambda cid, b=brick: (b, b.nbytes)
            )

    def is_resident(self, node: NodeId) -> bool:
        return node.id in self.texture_cache

    # --------------------------------------------------------------- frame
    def select(
        self,
        frustum: Frustum,
        window_height: int,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        data_range: Tuple[float, float] = (0.0, 1.0),
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
    ) -> List[NodeId]:
        return select_visibles(
            self.datasource,
            frustum,
            window_height,
            screen_space_error,
            min_lod,
            max_lod,
            data_range,
            clip_planes,
            time_step,
        )

    def render_bricked(
        self,
        camera: Camera,
        frustum: Frustum,
        params: Optional[RenderParams] = None,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
        synchronous: bool = True,
        data_range: Tuple[float, float] = (0.0, 1.0),
        n_planes: Optional[int] = None,
        collect_histogram: bool = False,
    ) -> Tuple[torch.Tensor, RenderStatistics]:
        """Frame over the LOD rendering set streamed through the device
        brick atlas → ((H, W, 4) f32 tensor on the engine's device,
        statistics).

        The rendering set is assembled once into a density store cached
        per (axis, set); each later frame of the same set is one view
        vector upload, the sweep kernel and the warp."""
        if not synchronous:
            raise NotImplementedError(
                "render_bricked(synchronous=False): asynchronous rendering "
                "is ROADMAP M5"
            )
        if collect_histogram:
            raise NotImplementedError(
                "render_bricked(collect_histogram=True): histograms are "
                "ROADMAP M6"
            )
        vx, vy, vw, vh = camera.viewport
        visibles = self.select(
            frustum, vh, screen_space_error, min_lod, max_lod,
            data_range, clip_planes, time_step,
        )
        stats = RenderStatistics()
        self.prefetch_batch(visibles)
        render_nodes = list(visibles)
        stats.n_available = len(render_nodes)
        stats.n_render_available = len(render_nodes)

        info = self.info
        half = np.asarray(info.world_size, np.float32) * 0.5
        if params is None:
            max_level = max((n.level for n in render_nodes), default=0)
            spr = n_planes or nyquist_samples_per_ray(
                info.voxels, info.root_node.depth, max_level
            )
            params = RenderParams(
                n_samples_per_ray=spr,
                data_source_range=self.data_source_range,
            )
        swp = sw.ShearWarpParams(
            n_planes=n_planes or params.n_samples_per_ray,
            inter_size=(vh, vw),
        )
        sw_plan = sw.make_view_plan(camera, swp.slope_margin)
        axis = sw_plan.axis
        clip_arr = (
            clip_planes.as_array() if clip_planes is not None else None
        )

        if not render_nodes:
            return torch.zeros((vh, vw, 4), device=self.device), stats

        render_level = max(n.level for n in render_nodes)
        depth = info.root_node.depth
        shift = depth - 1 - render_level
        fine_xyz = tuple(max(1, d >> shift) for d in info.voxels)
        perm = sw._PERM[axis]
        na, nc, nb = (
            (fine_xyz[2], fine_xyz[1], fine_xyz[0])[p] for p in perm
        )
        store_bytes = na * nc * nb * 4
        # The derived-cache share of the device budget — NOT the atlas
        # bytes, which are already spoken for.
        budget = self.device_budget.budget
        if store_bytes > budget or len(render_nodes) > self.atlas.n_slots:
            raise NotImplementedError(
                f"render_bricked: a {store_bytes} B store over "
                f"{len(render_nodes)} bricks exceeds the {budget} B store "
                f"budget or the {self.atlas.n_slots}-slot atlas; the "
                "out-of-core slab multipass is ROADMAP M5"
            )

        set_key = (
            axis,
            tuple(sorted(n.id for n in render_nodes)),
            time_step,
            params.data_source_range,
            render_level,
        )
        cached = self._store_cache.get(set_key)
        if cached is None:
            entries = [e.pin() for e in self._upload_nodes(render_nodes)]
            try:
                slot_of = {
                    n.id: e.value for n, e in zip(render_nodes, entries)
                }
                plan = swb.build_assembly_plan(
                    self.datasource, render_nodes, axis,
                    lambda n: slot_of[n.id],
                    params.data_source_range,
                    render_level=render_level,
                )
                store = swb.assemble_store(self.atlas.data, plan)
                content = swb.store_content(store)
            finally:
                for e in entries:
                    e.unpin()
            cached = (store, content, plan)
            self._store_cache.put(
                set_key, cached, _nbytes(store) + _nbytes(content)
            )
        store, content, plan = cached
        stats.n_passes = 1
        rkey = (
            set_key,
            camera.viewport,
            swp.n_planes,
            params.early_exit,
            params.max_samples_per_ray,
            None if clip_arr is None else clip_arr.tobytes(),
        )
        runner = self._frame_runners.get(rkey)
        if runner is None:
            runner = swb.StoreFrameRunner(
                store, plan, params=params, swp=swp,
                world_min=-half, world_max=half,
                clip_planes_world=clip_arr, content=content,
                viewport=camera.viewport,
            )
            if len(self._frame_runners) > 64:
                self._frame_runners.clear()
            self._frame_runners[rkey] = runner
        img = runner(store, self.transfer_function, camera, sw_plan)
        return img, stats

    # ---------------------------------------------------------- shearwarp
    def _level_volume(self, level: int, time_step: int = 0) -> np.ndarray:
        """Dense (Z, Y, X) f32 volume of one LOD level, assembled from its
        bricks' interiors on the host and kept in the data cache under a
        synthetic id."""
        info = self.info
        shift = info.root_node.depth - 1 - level
        vx, vy, vz = (max(1, d >> shift) for d in info.voxels)
        bx, by, bz = info.block_size
        ox, oy, oz = info.overlap

        def loader(cache_id):
            vol = np.zeros((vz, vy, vx), np.float32)
            nodes = [
                NodeId.from_coords(level, (px, py, pz), time_step)
                for px in range(max(1, -(-vx // bx)))
                for py in range(max(1, -(-vy // by)))
                for pz in range(max(1, -(-vz // bz)))
            ]
            bricks = self.datasource.get_data_batch(nodes)
            for node, brick in zip(nodes, bricks):
                core = brick[
                    oz : brick.shape[0] - oz or None,
                    oy : brick.shape[1] - oy or None,
                    ox : brick.shape[2] - ox or None,
                ]
                px, py, pz = node.position
                z0, y0, x0 = pz * bz, py * by, px * bx
                ze, ye, xe = (
                    min(z0 + core.shape[0], vz),
                    min(y0 + core.shape[1], vy),
                    min(x0 + core.shape[2], vx),
                )
                vol[z0:ze, y0:ye, x0:xe] = core[: ze - z0, : ye - y0, : xe - x0]
            return vol, vol.nbytes

        # Synthetic cache id: level volumes share the data cache budget.
        cache_id = (1 << 62) | (time_step << 8) | level
        return self.data_cache.load(cache_id, loader=loader).value

    def render_shearwarp(
        self,
        camera: Camera,
        level: Optional[int] = None,
        time_step: int = 0,
        n_planes: Optional[int] = None,
        params: Optional[RenderParams] = None,
        backend: str = "auto",
    ) -> torch.Tensor:
        """Frame of a dense LOD level through the pre-classified
        shear-warp → (H, W, 4) f32 tensor on the engine's device.

        ``backend``: "pallas" sweeps a classified plane stack, cached per
        (level, time step, major axis, TF object, data range), so a
        steady frame is the view vector upload, the sweep
        (``shearwarp_dense.pre_sweep``: K5 on the card) and the warp;
        "jnp" runs the plain pipeline (``shearwarp.render``); "auto" takes
        "pallas" on a CUDA engine and "jnp" elsewhere.  The cache keys on
        ``id(transfer_function)``: assign a new TF tensor to re-classify,
        an edit in place is not seen."""
        if backend not in SHEARWARP_BACKENDS:
            raise ValueError(
                f"render_shearwarp: backend {backend!r} is not one of {SHEARWARP_BACKENDS}"
            )
        info = self.info
        if level is None:
            level = info.root_node.depth - 1
        if params is None:
            params = RenderParams(
                n_samples_per_ray=n_planes or max(max(info.voxels), 256),
                data_source_range=self.data_source_range,
                filter_mode="trilinear",
            )
        volume = self._level_volume(level, time_step)
        half = np.asarray(info.world_size, np.float32) * 0.5
        swp = sw.ShearWarpParams(
            n_planes=n_planes or params.n_samples_per_ray,
            inter_size=(camera.viewport[3], camera.viewport[2]),
        )
        if backend == "auto":
            backend = "pallas" if self.device.type == "cuda" else "jnp"
        tf = self.transfer_function
        if backend == "jnp":
            return sw.render(
                torch.from_numpy(volume).to(self.device), tf, camera, params,
                -half, half, swp,
            )

        plan = sw.make_view_plan(camera, swp.slope_margin)
        key = (level, time_step, plan.axis, id(tf), params.data_source_range)
        cached = self._classified_cache.get(key)
        if cached is None:
            chans = swd.classify_planes(
                torch.from_numpy(volume).to(self.device), tf, plan.axis,
                params.data_source_range,
            )
            content = swd.slice_content(chans)
            cached = (chans, content)
            self._classified_cache.put(key, cached, _nbytes(chans) + _nbytes(content))
        chans, content = cached
        pa = swd.slope_grid_plan_args(plan, -half, half, params, swp)
        return swd.render_frame(
            chans, chans.shape[1], chans.shape[2], camera, pa, content=content
        )

    def render(
        self,
        camera: Camera,
        frustum: Frustum,
        params: Optional[RenderParams] = None,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
        synchronous: bool = True,
        collect_histogram: bool = False,
        data_range: Tuple[float, float] = (0.0, 1.0),
        marcher: str = "auto",
    ) -> Tuple[torch.Tensor, RenderStatistics, None]:
        """Exact frame → ((H, W, 4) f32 tensor on the engine's device,
        bottom-up rows; statistics; histogram, always None here).

        The rendering set is sorted front to back by brick centre
        distance and marched in passes of at most ``atlas.n_slots − 1``
        atlas-resident bricks, the per-ray (rgb, a) carried from pass to
        pass (GLRaycastPipeline.cpp:148-186), once per jittered subpixel
        sample (fragRaycast.glsl:121-127) and averaged.

        ``marcher`` is "auto", "pallas" or "xla": the JAX package's two
        marchers give the same image, and here all three run the same
        one, ``exact.march_exact`` (K3 on a CUDA engine, its plain
        version on a CPU engine).  K3 reads each brick in place from its
        atlas slot, in the atlas's native dtype.
        """
        if marcher not in MARCHERS:
            raise ValueError(f"render: marcher {marcher!r} is not one of {MARCHERS}")
        if not synchronous:
            raise NotImplementedError(
                "render(synchronous=False): asynchronous rendering is ROADMAP M5"
            )
        if collect_histogram:
            raise NotImplementedError(
                "render(collect_histogram=True): histograms are ROADMAP M6"
            )
        vx, vy, vw, vh = camera.viewport
        visibles = self.select(
            frustum, vh, screen_space_error, min_lod, max_lod,
            data_range, clip_planes, time_step,
        )
        stats = RenderStatistics()
        self.prefetch_batch(visibles)
        render_nodes = list(visibles)
        stats.n_available = len(render_nodes)

        if params is None:
            max_level = max((n.level for n in render_nodes), default=0)
            params = RenderParams(
                n_samples_per_ray=nyquist_samples_per_ray(
                    self.info.voxels, self.info.root_node.depth, max_level
                ),
                data_source_range=self.data_source_range,
                filter_mode=self.filter_mode,
            )

        eye_np = np.asarray(camera.inv_mv, np.float32)[:3, 3]
        order_nodes = self._sort_nodes(render_nodes, eye_np)
        batch = max(1, self.atlas.n_slots - 1)
        max_steps = self._max_steps(order_nodes, params)
        clip_arr = clip_planes.as_array() if clip_planes is not None else None
        half = np.asarray(self.info.world_size, np.float32) * 0.5
        tf = self.transfer_function.contiguous()

        sample_imgs = []
        for si in range(max(1, params.samples_per_pixel)):
            eye, dirs, cos_z, _ = ray_ops.make_rays(
                camera.inv_proj, camera.inv_mv, camera.viewport,
                sample_index=si, device=self.device,
            )
            dirs = dirs.reshape(-1, 3)
            tnp_ = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
            pack = ray_pack(eye, dirs, tnp_, params.step_size, -half, half, clip_arr)
            carry = torch.zeros((dirs.shape[0], 4), device=self.device)
            for start in range(0, len(order_nodes), batch):
                pass_nodes = order_nodes[start : start + batch]
                if si == 0:
                    stats.n_passes += 1
                entries = [e.pin() for e in self._upload_nodes(pass_nodes)]
                try:
                    slots, boxes = self._pass_operands(
                        pass_nodes, [e.value for e in entries]
                    )
                    # Launched on the current stream: a later pass's
                    # upload into a released slot is ordered after it.
                    carry = exact.march_exact(
                        self.atlas.data, slots, boxes, tf, pack, carry, eye_np,
                        params, max_steps=max_steps, width=vw,
                    )
                finally:
                    for e in entries:
                        e.unpin()
            sample_imgs.append(carry)
        rgb_a = sum(sample_imgs) / float(len(sample_imgs))
        stats.n_render_available = len(order_nodes)
        return rgb_a.reshape(vh, vw, 4), stats, None

    def _world_boxes(self, nodes: Sequence[NodeId]) -> Tuple[np.ndarray, np.ndarray]:
        """(N, 3) world box corners of ``nodes`` (float64 holding f32 values)."""
        lns = [self.datasource.get_node(n) for n in nodes]
        return (
            np.asarray([ln.world_box_min for ln in lns], np.float64),
            np.asarray([ln.world_box_max for ln in lns], np.float64),
        )

    def _sort_nodes(self, nodes: Sequence[NodeId], eye: np.ndarray) -> List[NodeId]:
        if not nodes:
            return []
        wmin, wmax = self._world_boxes(nodes)
        return [nodes[i] for i in sort_bricks_front_to_back(wmin, wmax, eye)]

    def _max_steps(self, nodes: Sequence[NodeId], params: RenderParams) -> int:
        if not nodes:
            return 1
        wmin, wmax = self._world_boxes(nodes)
        return max_steps_for_bricks(wmin, wmax, params.step_size)

    def _pass_operands(
        self, nodes: Sequence[NodeId], slots: Sequence[int]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The march's per-brick operands for one pass on the device: the
        atlas slots (B,) int32 and ``raycast.brick_boxes`` (B, 16)."""
        wmin, wmax = self._world_boxes(nodes)
        n = len(nodes)
        boxes = brick_boxes(
            wmin, wmax, np.tile(self._tex_min, (n, 1)), np.tile(self._tex_max, (n, 1))
        )
        slot_t = torch.as_tensor(np.asarray(slots, np.int32))
        return slot_t.to(self.device), boxes.to(self.device)
