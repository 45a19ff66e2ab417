"""Render engine: LOD selection → rendering set → upload → frame
(``libre_tpu.render.engine``).

Per frame, as in renderers/glRaycaster/GLRaycastPipeline.cpp:78-350:

  * ``select_visibles`` picks the LOD brick set for the view (SSE DFS);
  * bricks stream datasource → host data cache (LRU) → device atlas
    slots;
  * :meth:`render_bricked`: the rendering set is assembled into one
    density store on the device, cached across frames, and swept by the
    post-classification kernel (``ops/shearwarp_bricked.py``);
  * :meth:`render_wall`: N such views of the volume written into one
    device canvas, each through its cached store and runner, with no host
    synchronisation between views (the service's multi-view layouts);
  * :meth:`render`: the exact marcher (``ops/exact.py``) walks the set
    front to back in memory-bounded passes of atlas-resident bricks,
    with the per-ray (rgb, a) carried across passes
    (GLRaycastPipeline.cpp:148-186);
  * :meth:`render_shearwarp`: one dense LOD level, classified once per
    (level, time step, axis, TF) into an RGBA plane stack, cached, and
    swept by the pre-classified kernel (``ops/shearwarp_dense.py``).

With a ``mesh`` (``parallel/mesh.py``), :meth:`render_bricked` routes
through :meth:`render_bricked_sharded`: slope rows over the mesh's ray
axis, front-to-back plane ranges over its brick axis (K1 once per shard),
the segments folded in rank order; where the rows or planes do not divide
the mesh it warns once and renders on the one device.

When the assembled store exceeds the derived-cache budget or the
rendering set exceeds the atlas's slots, :meth:`render_bricked` renders
in A-slab passes, paging each slab's bricks through the atlas.  With
``synchronous=False`` both :meth:`render_bricked` and :meth:`render`
render what is resident (or its nearest resident ancestor) and upload
the rest on a thread pool, for progressive refinement.  With
``collect_histogram=True`` both merge the per-brick histograms of the
frame's rendering set (:meth:`accumulate_histogram`, HistogramFilter.cpp).

Every frame method runs its device work on the atlas's stream, the one
the uploads use (:meth:`BrickAtlas.on_stream`), whatever stream the caller
is on; the caller's stream waits for the frame before it reads the image.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.core.cache import CacheEntry, CacheLoadError, LRUCache
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
from libre_tpu_torch.ops.histogram_ops import Histogram, compute_brick_histogram
from libre_tpu_torch.ops.raycast import brick_boxes, ray_pack, sort_bricks_front_to_back
from libre_tpu_torch.ops.reference import (
    Camera,
    RenderParams,
    max_steps_for_bricks,
    nyquist_samples_per_ray,
)
from libre_tpu_torch.ops.transfer_function import default_color_map
from libre_tpu_torch.parallel import bricked_sharded
from libre_tpu_torch.parallel.compositing import move
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, require_mesh

MARCHERS = ("auto", "pallas", "xla")
SHEARWARP_BACKENDS = ("auto", "pallas", "jnp")


@dataclasses.dataclass
class RenderStatistics:
    """Availability counters (FrameInfo.h RenderStatistics).

    ``pending_uploads`` holds the futures of the uploads an asynchronous
    frame started, so that the caller can render again when they land
    (RenderingDone = false → redraw, GLRaycastPipeline.cpp:241-308)."""

    n_available: int = 0
    n_not_available: int = 0
    n_render_available: int = 0
    n_passes: int = 0
    rendering_done: bool = True
    histogram: Optional[Histogram] = None
    pending_uploads: List = dataclasses.field(default_factory=list, repr=False)


@dataclasses.dataclass
class WallView:
    """One view of a wall as :meth:`RenderEngine.plan_wall` plans it: its
    camera, rendering set, the store view (params, ``ShearWarpParams``,
    view plan, render level), statistics and canvas offset (row, col)."""

    camera: Camera
    nodes: List[NodeId]
    params: RenderParams
    swp: sw.ShearWarpParams
    sw_plan: sw.ViewPlan
    render_level: int
    stats: RenderStatistics
    row: int
    col: int


def compute_rendering_set(
    visibles: Sequence[NodeId], is_loaded
) -> Tuple[List[NodeId], bool]:
    """Progressive-LOD fallback (RenderingSetGeneratorFilter.ipp:27-134).

    For each visible node take it if loaded, else its nearest loaded
    ancestor; drop nodes whose substitute or an ancestor of it is already
    in the set (looked up by id, one probe per ancestor).  Returns (render
    list, rendering_done = every visible was loaded itself)."""
    chosen: List[NodeId] = []
    seen = set()
    done = True
    for node in visibles:
        pick: Optional[NodeId] = None
        if is_loaded(node):
            pick = node
        else:
            done = False
            for anc in node.parents():
                if is_loaded(anc):
                    pick = anc
                    break
        if pick is not None and pick.id not in seen:
            if not any(anc.id in seen for anc in pick.parents()):
                seen.add(pick.id)
                chosen.append(pick)
    return chosen, done


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
# Bricks per batch of an asynchronous frame's uploads: each batch is
# resident as soon as its copy is enqueued, so frames refine batch by
# batch.
UPLOAD_BATCH = 256


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_atlas_stream(method):
    """Run a frame method's device work on the atlas's stream
    (:meth:`BrickAtlas.on_stream`).  The tensors it returns were made on
    that stream; each is marked as used by the caller's stream, so that
    their memory is not reused before the caller's work on them ran."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self.atlas.on_stream() as caller:
            out = method(self, *args, **kwargs)
        if caller is not None:
            for t in out if isinstance(out, tuple) else (out,):
                if isinstance(t, torch.Tensor):
                    t.record_stream(caller)
        return out

    return wrapped


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
        n_upload_threads: int = 4,
        filter_mode: str = "nearest",
        device="cuda",
        mesh=None,
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
        # Per-brick histograms (HistogramCache), merged per frame by
        # :meth:`accumulate_histogram`.
        self.histogram_cache: LRUCache[Histogram] = LRUCache(
            "HistogramCache", 1 << 30
        )
        # Asynchronous datasource → host loads and host → atlas uploads
        # (the Tuyau upload executors, GLRaycastPipeline.cpp:58-75).
        self._upload_pool = ThreadPoolExecutor(max_workers=n_upload_threads)
        # Node ids of the bricks whose asynchronous upload is under way.
        self._uploading: set = set()
        self._uploading_lock = threading.Lock()

        self.transfer_function = torch.from_numpy(default_color_map()).to(
            self.device
        )
        self.data_source_range = info.data_type.default_range

        # Derived device tensors, byte-accounted against the shared
        # device budget (LRU across both pools): classified plane stacks
        # (dense path) keyed by (level, time_step, axis, id(TF), data
        # range), each holding its TF and the TF's version, and assembled
        # density stores (bricked path) keyed by (axis, set ids,
        # time_step, data range, level).  Several entries
        # let orbiting across an axis boundary reuse instead of rebuild.
        self._classified_cache = _ByteLRU(self.device_budget)
        self._store_cache = _ByteLRU(self.device_budget)
        # Steady-state frame runners keyed by (set_key, view statics).
        self._frame_runners: Dict[tuple, swb.StoreFrameRunner] = {}

        # The (ray × brick) mesh bricked frames shard over (render_cli
        # --mesh, RenderService(mesh=...), or set directly), and the
        # frames that ran sharded.
        self.mesh = None if mesh is None else require_mesh("RenderEngine", mesh)
        self.sharded_frames = 0
        self._mesh_fallback_warned = False

    # ------------------------------------------------------------------ IO
    def _load_brick(self, cache_id: int) -> Tuple[np.ndarray, int]:
        data = self.datasource.get_data(NodeId(cache_id))
        return data, data.nbytes

    def _upload_async(self, nodes: Sequence[NodeId]) -> List:
        """Start the uploads of the ``nodes`` neither resident nor already
        under way, at most ``n_slots − 1`` of them, on the upload pool in
        batches of ``UPLOAD_BATCH`` bricks; returns the futures."""
        with self._uploading_lock:
            todo = [
                n for n in nodes
                if not self.is_resident(n) and n.id not in self._uploading
            ][: max(1, self.atlas.n_slots - 1)]
            self._uploading.update(n.id for n in todo)
        return [
            self._upload_pool.submit(self._upload_batch, todo[i : i + UPLOAD_BATCH])
            for i in range(0, len(todo), UPLOAD_BATCH)
        ]

    def _upload_batch(self, nodes: Sequence[NodeId]) -> None:
        try:
            for e in self._upload_nodes(nodes):
                e.unpin()
        finally:
            with self._uploading_lock:
                self._uploading.difference_update(n.id for n in nodes)

    def _upload_nodes(self, nodes: Sequence[NodeId]) -> List[CacheEntry]:
        """Batched host → atlas upload: one copy for every missing brick.
        Returns the texture-cache entries in ``nodes`` order, pinned: the
        caller unpins them once the kernels that read their slots are
        enqueued.  An entry that an upload thread evicted between its
        lookup and its pin is uploaded again."""
        entries: Dict[int, CacheEntry] = {}
        try:
            while True:
                for n in nodes:
                    if id(n) not in entries:
                        e = self.texture_cache.get(n.id)
                        if e is not None:
                            entries[id(n)] = e.pin()
                missing = [n for n in nodes if id(n) not in entries]
                if missing:
                    self._upload_missing(missing, entries)
                stale = [n for n in nodes if not self.texture_cache.holds(entries[id(n)])]
                if not stale:
                    return [entries[id(n)] for n in nodes]
                for n in stale:
                    entries.pop(id(n)).unpin()
        except BaseException:
            for e in entries.values():
                e.unpin()
            raise

    def _upload_missing(self, missing: Sequence[NodeId], entries: Dict[int, CacheEntry]) -> None:
        """Upload ``missing`` in one batch and add their entries, pinned,
        to ``entries`` (keyed by ``id`` of the node)."""
        self.prefetch_batch(missing)
        datas = [self.data_cache.load(n.id).value for n in missing]
        self.texture_cache.ensure_budget(self.atlas.slot_bytes * len(missing))
        slots: List[int] = []
        try:
            for _ in missing:
                slots.append(self.atlas.acquire())
            self.atlas.upload_many(slots, datas)
        except BaseException:
            for s in slots:
                self.atlas.release(s)
            raise
        for n, s in zip(missing, slots):
            e = self.texture_cache.load(
                n.id, loader=lambda cid, s=s: (s, self.atlas.slot_bytes)
            ).pin()
            if e.value != s:
                # Another thread inserted this node first; return our
                # pre-acquired slot to the pool.
                self.atlas.release(s)
            entries[id(n)] = e

    def prefetch(self, nodes: Sequence[NodeId]) -> List:
        """Asynchronous datasource → host loads on the upload pool;
        returns the futures."""
        return [
            self._upload_pool.submit(self.data_cache.load, node.id)
            for node in nodes
            if node.id not in self.data_cache
        ]

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

    def prefetch_view(
        self,
        frustum: Frustum,
        window_height: int,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        data_range: Tuple[float, float] = (0.0, 1.0),
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
    ) -> List:
        """Camera-path look-ahead: asynchronous datasource → host loads of
        the next frame's visible set while this frame's kernels run
        (GLRenderUploadFilter.cpp:79-107).  Returns the futures."""
        visibles = self.select(
            frustum, window_height, screen_space_error, min_lod,
            max_lod, data_range, clip_planes, time_step,
        )
        return self.prefetch(visibles)

    @_on_atlas_stream
    def upload_view(
        self,
        frustum: Frustum,
        window_height: int,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        data_range: Tuple[float, float] = (0.0, 1.0),
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
    ) -> int:
        """Atlas-level look-ahead: push the next frame's visible bricks
        datasource → host → atlas.  Call it after this frame's kernels
        are enqueued: the uploads go on the atlas's stream behind them, so
        an eviction cannot reach a slot they read, and the host's part of
        the upload runs while they do.  Returns the number of bricks
        uploaded (at most ``n_slots − 1``)."""
        visibles = self.select(
            frustum, window_height, screen_space_error, min_lod,
            max_lod, data_range, clip_planes, time_step,
        )
        missing = [n for n in visibles if not self.is_resident(n)]
        missing = missing[: max(1, self.atlas.n_slots - 1)]
        if missing:
            for e in self._upload_nodes(missing):
                e.unpin()
        return len(missing)

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

    def _slab_nodes(
        self, rendering_set: Sequence[NodeId], axis: int,
        a_lo: int, a_hi_incl: int, render_level: int,
    ) -> List[NodeId]:
        """Rendering-set nodes whose level-local tile layers, with the +1
        guard layer of the upsample taps, meet render-level A-rows
        [a_lo, a_hi_incl]: the bricks a slab pass must have in the atlas."""
        info = self.info
        perm = sw._PERM[axis]
        ba = (info.block_size[2], info.block_size[1], info.block_size[0])[perm[0]]
        # Node positions are (x, y, z); the major axis is array dim
        # perm[0] of (Z, Y, X), so position component 2 − perm[0].
        pos_idx = 2 - perm[0]
        out = []
        for n in rendering_set:
            f = 1 << (render_level - n.level)
            c_lo = max(0, int(np.floor((a_lo + 0.5) / f - 0.5)) - 1)
            c_hi = int(np.ceil((a_hi_incl + 0.5) / f - 0.5)) + 1
            if c_lo // ba <= n.position[pos_idx] <= c_hi // ba:
                out.append(n)
        return out

    def _rendering_nodes(self, visibles: Sequence[NodeId], synchronous: bool, stats):
        """The frame's rendering set.  Synchronous: every visible brick,
        loaded to the host cache first.  Otherwise: what is resident, or
        its nearest resident ancestor (:func:`compute_rendering_set`), with
        uploads of the rest started on the upload pool (:meth:`_upload_async`)."""
        if synchronous:
            self.prefetch_batch(visibles)
            render_nodes = list(visibles)
        else:
            render_nodes, stats.rendering_done = compute_rendering_set(
                visibles, self.is_resident
            )
            stats.pending_uploads = self._upload_async(visibles)
        stats.n_available = len(render_nodes)
        stats.n_not_available = len(visibles) - len(render_nodes)
        return render_nodes

    @_on_atlas_stream
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
        relative_viewport: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
    ) -> Tuple[torch.Tensor, RenderStatistics]:
        """Frame over the LOD rendering set streamed through the device
        brick atlas → ((H, W, 4) f32 tensor on the engine's device,
        statistics).

        In core, the rendering set is assembled once into a density store
        cached per (axis, set); each later frame of the same set is one
        view vector upload, the sweep kernel and the warp.  When the store
        exceeds the derived-cache budget or the set exceeds the atlas's
        slots, the frame runs in A-slab passes: each pass pages its
        bricks into the atlas (in atlas-sized chunks if they do not fit),
        assembles its slab and sweeps its planes onto the carry, bit for
        bit one sweep (GLRaycastPipeline.cpp:148-186).

        With ``collect_histogram`` ``stats.histogram`` merges the
        histograms of the rendering set the frame composites, in core,
        out of core and asynchronous alike, each brick counted by the
        channel whose share ``relative_viewport`` of the viewport holds
        its centre (:meth:`accumulate_histogram`).

        With ``self.mesh`` set, the frame routes through
        :meth:`render_bricked_sharded`, falling back here (with one
        warning) where that raises ValueError: the viewport height or the
        plane count does not divide the mesh axes, or the set exceeds the
        atlas."""
        kw = dict(
            params=params, screen_space_error=screen_space_error,
            min_lod=min_lod, max_lod=max_lod, clip_planes=clip_planes,
            time_step=time_step, synchronous=synchronous,
            data_range=data_range, n_planes=n_planes,
            collect_histogram=collect_histogram,
            relative_viewport=relative_viewport,
        )
        if self.mesh is not None:
            try:
                return self.render_bricked_sharded(camera, frustum, self.mesh, **kw)
            except ValueError as exc:
                log = logging.getLogger(__name__)
                if not self._mesh_fallback_warned:
                    self._mesh_fallback_warned = True
                    log.warning("mesh-sharded frame fell back to single-device: %s", exc)
                else:
                    log.debug("mesh fallback: %s", exc)
        vx, vy, vw, vh = camera.viewport
        visibles = self.select(
            frustum, vh, screen_space_error, min_lod, max_lod,
            data_range, clip_planes, time_step,
        )
        stats = RenderStatistics()
        render_nodes = self._rendering_nodes(visibles, synchronous, stats)
        stats.n_render_available = len(render_nodes)
        if collect_histogram:
            stats.histogram = self.accumulate_histogram(
                render_nodes, frustum, relative_viewport
            )

        params, swp, sw_plan, render_level, (na, nc, nb) = self._store_view(
            camera, render_nodes, params, n_planes
        )
        clip_arr = (
            clip_planes.as_array() if clip_planes is not None else None
        )

        if not render_nodes:
            return torch.zeros((vh, vw, 4), device=self.device), stats

        store_bytes = na * nc * nb * 4
        # The derived-cache share of the device budget — NOT the atlas
        # bytes, which are already spoken for.
        budget = self.device_budget.budget
        if store_bytes > budget or len(render_nodes) > self.atlas.n_slots:
            img = self._render_slabs(
                render_nodes, render_level, (na, nc, nb), camera, sw_plan,
                params, swp, clip_arr, stats,
            )
            return img, stats

        stats.n_passes = 1
        runner, store = self._store_frame_runner(
            camera, render_nodes, params, swp, sw_plan, render_level, clip_arr, time_step
        )
        img = runner(store, self.transfer_function, camera, sw_plan)
        return img, stats

    def _store_frame_runner(
        self, camera, render_nodes, params, swp, sw_plan, render_level, clip_arr, time_step
    ) -> Tuple[swb.StoreFrameRunner, torch.Tensor]:
        """The in-core frame's cached (runner, store): the set's store
        keyed by (axis, set, time step, data range, level), its runner by
        that key and the viewport, planes, early exit, sample rate and
        clip planes."""
        half = np.asarray(self.info.world_size, np.float32) * 0.5
        set_key = (
            sw_plan.axis,
            tuple(sorted(n.id for n in render_nodes)),
            time_step,
            params.data_source_range,
            render_level,
        )
        store, content, plan = self._cached_store(
            set_key, render_nodes, sw_plan.axis, params, render_level
        )
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
        return runner, store

    def render_wall(
        self,
        views: Sequence[tuple],
        canvas_size: Tuple[int, int],
        params: Optional[RenderParams] = None,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
        data_range: Tuple[float, float] = (0.0, 1.0),
        n_planes: Optional[int] = None,
    ) -> Tuple[torch.Tensor, List[RenderStatistics]]:
        """Multi-view wall (``libre_tpu.render.engine.render_wall``; the
        reference renders wall channels in parallel, Config.cpp:394-491)
        → ((H, W, 4) f32 canvas on the engine's device, statistics per
        view): :meth:`plan_wall`, then :meth:`draw_wall`.

        ``views``: a sequence of (camera, frustum, (dx, dy)).  Raises
        ``ValueError``, before any view renders, where a view's rendering
        set is empty or its store does not take the single-store path (the
        store over the derived budget or the set over the atlas's slots),
        as the JAX method does."""
        plan, why = self.plan_wall(
            views, canvas_size, params=params, screen_space_error=screen_space_error,
            min_lod=min_lod, max_lod=max_lod, clip_planes=clip_planes,
            time_step=time_step, data_range=data_range, n_planes=n_planes,
        )
        if why is not None:
            raise ValueError(why)
        return self.draw_wall(plan, canvas_size, clip_planes, time_step)

    def plan_wall(
        self,
        views: Sequence[tuple],
        canvas_size: Tuple[int, int],
        params: Optional[RenderParams] = None,
        screen_space_error: float = 4.0,
        min_lod: int = 0,
        max_lod: int = (1 << 4) - 1,
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
        data_range: Tuple[float, float] = (0.0, 1.0),
        n_planes: Optional[int] = None,
    ) -> Tuple[List[WallView], Optional[str]]:
        """The host half of :meth:`render_wall`, view by view: select,
        prefetch to the host (as a synchronous frame), the store view, and
        the two tests of the wall path → (the views' plans, None), or at
        the first view that fails a test (the plans so far, why).  The
        canvas offset is clamped so that the view fits, as the JAX wall's
        ``dynamic_update_slice``."""
        ch, cw = canvas_size
        plan: List[WallView] = []
        for camera, frustum, (dx, dy) in views:
            vx, vy, vw, vh = camera.viewport
            if vh > ch or vw > cw:
                return plan, f"wall view {vw}x{vh} larger than the {cw}x{ch} canvas"
            visibles = self.select(
                frustum, vh, screen_space_error, min_lod, max_lod,
                data_range, clip_planes, time_step,
            )
            self.prefetch_batch(visibles)
            nodes = list(visibles)
            stats = RenderStatistics(
                n_available=len(nodes), n_render_available=len(nodes), n_passes=1
            )
            if not nodes:
                return plan, "wall view with empty rendering set"
            params_v, swp, sw_plan, render_level, (na, nc, nb) = self._store_view(
                camera, nodes, params, n_planes
            )
            if na * nc * nb * 4 > self.device_budget.budget or len(nodes) > self.atlas.n_slots:
                return plan, "wall view too large for the single-store path"
            plan.append(WallView(
                camera, nodes, params_v, swp, sw_plan, render_level, stats,
                min(max(int(dy), 0), ch - vh), min(max(int(dx), 0), cw - vw),
            ))
        return plan, None

    @_on_atlas_stream
    def draw_wall(
        self,
        plan: Sequence[WallView],
        canvas_size: Tuple[int, int],
        clip_planes: Optional[ClipPlanes] = None,
        time_step: int = 0,
    ) -> Tuple[torch.Tensor, List[RenderStatistics]]:
        """The device half of :meth:`render_wall`: each planned view
        through its cached store and ``StoreFrameRunner`` (K1 and the
        warp), as :meth:`render_bricked` renders it in core, written into
        one (H, W, 4) canvas at its offset, on the atlas's stream, with no
        host synchronisation or device → host copy between views; the
        caller makes the one copy of the canvas."""
        clip_arr = clip_planes.as_array() if clip_planes is not None else None
        canvas = torch.zeros((*canvas_size, 4), dtype=torch.float32, device=self.device)
        for v in plan:
            runner, store = self._store_frame_runner(
                v.camera, v.nodes, v.params, v.swp, v.sw_plan, v.render_level, clip_arr,
                time_step,
            )
            vw, vh = v.camera.viewport[2:]
            canvas[v.row : v.row + vh, v.col : v.col + vw] = runner(
                store, self.transfer_function, v.camera, v.sw_plan
            )
        return canvas, [v.stats for v in plan]

    @_on_atlas_stream
    def render_bricked_sharded(
        self,
        camera: Camera,
        frustum: Frustum,
        mesh,
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
        relative_viewport: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0),
    ) -> Tuple[torch.Tensor, RenderStatistics]:
        """Bricked frame over a (ray × brick) mesh → ((H, W, 4) on the
        engine's device, statistics): BASELINE config 4, a large
        multi-brick volume decomposed across devices.

        Sort-last: the brick axis splits the GLOBAL plane grid into
        front-to-back ranges; sort-first: the ray axis shards slope-grid
        rows; K1 launches once per shard and the segments fold with the
        over operator in rank order (the Channel DB compositing of
        livre/eq/Channel.cpp:444-586).  When the whole store fits the
        derived-cache budget, the frame reads the SAME cached store as
        :meth:`render_bricked` (replicated to the shards), so an orbit
        reassembles nothing; otherwise each brick-axis shard gets a slab
        of the slices its planes bracket, assembled fresh per view
        (``bricked_sharded.build_sharded_slabs``, 1/d_k of the store).
        ``synchronous=False`` renders the rendering set and uploads the
        rest, as :meth:`render_bricked` does.  The viewport height must
        divide the ray axis and the plane count the brick axis, and the
        visible set must fit the atlas (else ValueError, before any
        assembly); ``stats.n_passes`` is the brick-axis size."""
        mesh = require_mesh("render_bricked_sharded", mesh)
        vx, vy, vw, vh = camera.viewport
        visibles = self.select(
            frustum, vh, screen_space_error, min_lod, max_lod,
            data_range, clip_planes, time_step,
        )
        if len(visibles) > self.atlas.n_slots:
            raise ValueError(
                f"{len(visibles)} bricks exceed the atlas's {self.atlas.n_slots} slots"
            )
        stats = RenderStatistics()
        render_nodes = self._rendering_nodes(visibles, synchronous, stats)
        stats.n_render_available = len(render_nodes)
        half = np.asarray(self.info.world_size, np.float32) * 0.5
        params, swp, sw_plan, render_level, (na, nc, nb) = self._store_view(
            camera, render_nodes, params, n_planes
        )
        bricked_sharded.check_divides(mesh, vh, swp.n_planes)
        if collect_histogram:
            stats.histogram = self.accumulate_histogram(
                render_nodes, frustum, relative_viewport
            )
        if not render_nodes:
            self.sharded_frames += 1
            return torch.zeros((vh, vw, 4), device=self.device), stats

        axis = sw_plan.axis
        replicated = na * nc * nb * 4 <= self.device_budget.budget
        d_k = mesh.shape[BRICK_AXIS]
        clip_arr = clip_planes.as_array() if clip_planes is not None else None
        sweep = swb.SlabSweep(
            device=self.device, axis=axis, na=na, params=params, swp=swp,
            world_min=-half, world_max=half, clip_planes_world=clip_arr,
            viewport=camera.viewport,
        )
        fv_host = sweep.view_vector(camera, sw_plan)
        set_key = (
            axis,
            tuple(sorted(n.id for n in render_nodes)),
            time_step,
            params.data_source_range,
            render_level,
        )
        if replicated:
            store, content, _plan = self._cached_store(
                set_key, render_nodes, axis, params, render_level
            )
            a_base = None
        else:
            content = None
            store, a_base = self._with_assembly_plan(
                render_nodes, axis, params, render_level,
                lambda plan: bricked_sharded.build_sharded_slabs(
                    self.atlas.data, plan, fv_host, swp.n_planes, d_k
                ),
            )
        stats.n_passes = d_k
        streams = self._frame_streams(mesh)
        fv = torch.from_numpy(fv_host).to(self.device)
        inter = bricked_sharded.render_store_grid_sharded(
            mesh, store, self.transfer_function, fv,
            na_real=na, nc_real=nc, nb_real=nb, k_planes=swp.n_planes,
            inter_size=swp.inter_size, wb0=sweep.wb[0], wb1=sweep.wb[1],
            wc0=sweep.wc[0], wc1=sweep.wc[1], early_exit=sweep.early_exit,
            clip=sweep.clip, n_clip=sweep.n_clip, a_base=a_base, content=content,
            streams=streams,
        )
        img = sweep.warp(move(inter, self.device, streams), fv)
        self.sharded_frames += 1
        return img, stats

    def _store_view(self, camera, render_nodes, params, n_planes):
        """A bricked frame's (params, ``ShearWarpParams``, view plan,
        render level, store dims (Na, Nc, Nb)): ``params`` by default the
        Nyquist rate of the set's finest level over the data range."""
        info = self.info
        vx, vy, vw, vh = camera.viewport
        render_level = max((n.level for n in render_nodes), default=0)
        if params is None:
            spr = n_planes or nyquist_samples_per_ray(
                info.voxels, info.root_node.depth, render_level
            )
            params = RenderParams(
                n_samples_per_ray=spr, data_source_range=self.data_source_range,
            )
        swp = sw.ShearWarpParams(
            n_planes=n_planes or params.n_samples_per_ray, inter_size=(vh, vw),
        )
        sw_plan = sw.make_view_plan(camera, swp.slope_margin)
        shift = info.root_node.depth - 1 - render_level
        fine_xyz = tuple(max(1, d >> shift) for d in info.voxels)
        dims = tuple((fine_xyz[2], fine_xyz[1], fine_xyz[0])[p] for p in sw._PERM[sw_plan.axis])
        return params, swp, sw_plan, render_level, dims

    def _with_assembly_plan(self, render_nodes, axis, params, render_level, assemble):
        """``assemble(plan)`` of the set's assembly plan, with the set's
        bricks uploaded and their atlas slots pinned meanwhile."""
        entries = self._upload_nodes(render_nodes)
        try:
            slot_of = {n.id: e.value for n, e in zip(render_nodes, entries)}
            plan = swb.build_assembly_plan(
                self.datasource, render_nodes, axis, lambda n: slot_of[n.id],
                params.data_source_range, render_level=render_level,
            )
            return assemble(plan)
        finally:
            for e in entries:
                e.unpin()

    def _cached_store(self, set_key, render_nodes, axis, params, render_level):
        """The set's (store, content, plan) from the store cache, or
        assembled, with its slice coverage, and cached."""
        cached = self._store_cache.get(set_key)
        if cached is None:
            def assemble(plan):
                store = swb.assemble_store(self.atlas.data, plan)
                return store, swb.store_content(store), plan

            cached = self._with_assembly_plan(render_nodes, axis, params, render_level, assemble)
            self._store_cache.put(set_key, cached, _nbytes(cached[0]) + _nbytes(cached[1]))
        return cached

    def _frame_streams(self, mesh) -> Dict[torch.device, torch.cuda.Stream]:
        """Each CUDA device of ``mesh``: the stream its share of a frame is
        ordered on — the atlas's on the atlas's device, the current one on
        the others."""
        streams = {}
        for dev in mesh.distinct_devices():
            if dev.type != "cuda":
                continue
            atlas_stream = self.atlas.stream
            if atlas_stream is not None and dev == atlas_stream.device:
                streams[dev] = atlas_stream
            else:
                streams[dev] = torch.cuda.current_stream(dev)
        return streams

    def _render_slabs(
        self, render_nodes, render_level, fine_dims, camera, sw_plan,
        params, swp, clip_arr, stats,
    ) -> torch.Tensor:
        """The out-of-core frame: A-slab passes with per-slab atlas
        paging.  Each pass makes only its own bricks resident (evicting
        earlier slabs' least recently used ones), assembles its slab and
        sweeps its planes of the frame's global tables onto the carry.
        The frame and its uploads run on the atlas's stream, so an
        evicted slot is refilled only after its last reader ran."""
        na, nc, nb = fine_dims
        axis = sw_plan.axis
        half = np.asarray(self.info.world_size, np.float32) * 0.5
        # Slab height: the derived budget, and whole block layers of the
        # render level that fit the atlas (a pass's bricks are resident
        # together while its slab is assembled).
        max_slices = max(2, int(self.device_budget.budget // (nc * nb * 4)))
        bs = max(1, int(self.info.block_size[0]))
        bricks_per_layer = max(1, (-(-nc // bs)) * (-(-nb // bs)))
        layers_fit = max(1, self.atlas.n_slots // bricks_per_layer)
        max_slices = min(max_slices, layers_fit * bs)
        sweep = swb.SlabSweep(
            device=self.device, axis=axis, na=na, params=params, swp=swp,
            world_min=-half, world_max=half, clip_planes_world=clip_arr,
            viewport=camera.viewport,
        )
        fv = torch.from_numpy(sweep.view_vector(camera, sw_plan)).to(self.device)
        tables = sweep.tables(fv)
        plans = swb.make_slab_plans(tables.a0.cpu().numpy(), na, max_slices)
        stats.n_passes = len(plans)
        pass_nodes = [
            self._slab_nodes(render_nodes, axis, sp.a_lo, sp.a_hi_incl, render_level)
            for sp in plans
        ]
        tf = self.transfer_function
        carry = (tables.rgb_in, tables.t_in)
        cap = max(1, self.atlas.n_slots - 1)
        for pi, sp in enumerate(plans):
            if pi + 1 < len(plans) and pass_nodes[pi + 1]:
                # Look-ahead: the next pass's datasource → host loads run
                # on the upload pool while this pass's kernels run.
                self.prefetch(pass_nodes[pi + 1])
            slab_nodes = pass_nodes[pi]
            if not slab_nodes:
                # No brick covers the slab: every sample masks to zero,
                # so skipping the pass is exact.
                continue
            # A slab may need more bricks than the atlas holds: page them
            # in atlas-sized chunks and combine the parts by maximum.  The
            # parts own disjoint voxels over the SENTINEL background.
            slab = None
            for cs in range(0, len(slab_nodes), cap):
                chunk = slab_nodes[cs : cs + cap]
                entries = self._upload_nodes(chunk)
                try:
                    slot_of = {n.id: e.value for n, e in zip(chunk, entries)}
                    plan = swb.build_assembly_plan(
                        self.datasource, chunk, axis, lambda n: slot_of[n.id],
                        params.data_source_range, render_level=render_level,
                    )
                    part = swb.assemble_store(self.atlas.data, plan, sp.a_lo, sp.a_hi_incl)
                finally:
                    for e in entries:
                        e.unpin()
                slab = part if slab is None else torch.maximum(slab, part)
            carry = sweep.run_pass(slab, tf, tables, sp, carry)
        return sweep.warp(carry[0], fv)

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

    @_on_atlas_stream
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
        "pallas" on a CUDA engine and "jnp" elsewhere.  A cached stack
        holds the TF tensor it was classified with and its ``_version``:
        it is reused only for that same tensor, unedited, so assigning a
        new TF tensor or editing the TF in place both re-classify."""
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
        # The entry keeps its TF alive, so no other tensor can take its id
        # while the entry exists; the version catches edits in place.
        key = (level, time_step, plan.axis, id(tf), params.data_source_range)
        cached = self._classified_cache.get(key)
        if cached is None or cached[2] is not tf or cached[3] != tf._version:
            chans = swd.classify_planes(
                torch.from_numpy(volume).to(self.device), tf, plan.axis,
                params.data_source_range,
            )
            content = swd.slice_content(chans)
            cached = (chans, content, tf, tf._version)
            self._classified_cache.put(key, cached, _nbytes(chans) + _nbytes(content))
        chans, content = cached[:2]
        pa = swd.slope_grid_plan_args(plan, -half, half, params, swp)
        return swd.render_frame(
            chans, chans.shape[1], chans.shape[2], camera, pa, content=content
        )

    @_on_atlas_stream
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
    ) -> Tuple[torch.Tensor, RenderStatistics, Optional[Histogram]]:
        """Exact frame → ((H, W, 4) f32 tensor on the engine's device,
        bottom-up rows; statistics; with ``collect_histogram`` the merged
        histogram of the rendering set, else None).

        The rendering set is sorted front to back by brick centre
        distance and marched in passes of at most ``atlas.n_slots − 1``
        atlas-resident bricks, the per-ray (rgb, a) carried from pass to
        pass (GLRaycastPipeline.cpp:148-186), once per jittered subpixel
        sample (fragRaycast.glsl:121-127) and averaged.  With
        ``synchronous=False`` it renders what is resident, or its nearest
        resident ancestor, uploads the rest on the upload pool and
        reports ``rendering_done=False`` until every visible brick was
        resident (renderAsync, GLRaycastPipeline.cpp:241-308).

        ``marcher`` is "auto", "pallas" or "xla": the JAX package's two
        marchers give the same image, and here all three run the same
        one, ``exact.march_exact`` (K3 on a CUDA engine, its plain
        version on a CPU engine).  K3 reads each brick in place from its
        atlas slot, in the atlas's native dtype.
        """
        if marcher not in MARCHERS:
            raise ValueError(f"render: marcher {marcher!r} is not one of {MARCHERS}")
        vx, vy, vw, vh = camera.viewport
        visibles = self.select(
            frustum, vh, screen_space_error, min_lod, max_lod,
            data_range, clip_planes, time_step,
        )
        stats = RenderStatistics()
        render_nodes = self._rendering_nodes(visibles, synchronous, stats)

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
                entries = self._upload_nodes(pass_nodes)
                try:
                    slots, boxes = self._pass_operands(
                        pass_nodes, [e.value for e in entries]
                    )
                    # Launched on the atlas's stream, where the frame runs:
                    # a later pass's upload into a released slot is
                    # ordered after it.
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
        histogram = self.accumulate_histogram(order_nodes) if collect_histogram else None
        return rgb_a.reshape(vh, vw, 4), stats, histogram

    # ---------------------------------------------------------- histogram
    def _center_in_viewport(self, frustum: Frustum, node: NodeId, rel_viewport) -> bool:
        """Cross-channel dedupe test (HistogramFilter.cpp:44-75): a brick
        rendered by several channels/tiles is counted by exactly the one
        whose viewport-extended NDC cube contains its world-box centre
        (borders of the absolute viewport extend to infinity; z always
        does)."""
        ln = self.datasource.get_node(node)
        center = (
            np.asarray(ln.world_box_min, np.float64)
            + np.asarray(ln.world_box_max, np.float64)
        ) * 0.5
        c = frustum.mvp.astype(np.float64) @ np.append(center, 1.0)
        if c[3] == 0.0:
            return False
        c = c[:3] / c[3]
        x0, y0, w, h = rel_viewport
        inf = np.inf
        lo = np.array([-inf if x0 == 0.0 else -1.0, -inf if y0 == 0.0 else -1.0, -inf])
        hi = np.array([inf if x0 + w == 1.0 else 1.0, inf if y0 + h == 1.0 else 1.0, inf])
        return bool(np.all(c >= lo) and np.all(c <= hi))

    def accumulate_histogram(
        self,
        nodes: Sequence[NodeId],
        frustum: Optional[Frustum] = None,
        relative_viewport: Optional[Tuple[float, float, float, float]] = None,
    ) -> Optional[Histogram]:
        """Merge per-brick histograms (HistogramFilter.cpp:44-129), each
        computed once from the host brick (its bins counted on the
        engine's device) and kept in ``histogram_cache``.

        With ``frustum`` + ``relative_viewport`` (this channel's share of
        the absolute viewport, [0,1]²), bricks whose centre falls in
        another channel's tile are skipped, so multi-view/multi-channel
        accumulations count each brick exactly once.  A brick that fails
        to load is skipped; one whose range is incompatible with the
        merged histogram's is purged from the cache and skipped."""
        total: Optional[Histogram] = None
        for node in nodes:
            if (
                frustum is not None
                and relative_viewport is not None
                and not self._center_in_viewport(frustum, node, relative_viewport)
            ):
                continue

            def loader(cache_id):
                data = self.data_cache.load(cache_id).value
                h = compute_brick_histogram(
                    data, self.info.overlap, self.info.data_type,
                    data_range=None if self.info.data_type.is_float else self.data_source_range,
                    device=self.device,
                )
                return h, h.bins.nbytes

            try:
                h = self.histogram_cache.load(node.id, loader=loader).value
            except CacheLoadError:
                continue
            if total is None:
                total = Histogram(h.bins.copy(), h.min_value, h.max_value)
            else:
                try:
                    total += h
                except ValueError:
                    # Incompatible ranges while the global range converges:
                    # purge and skip (HistogramFilter.cpp:111-129).
                    self.histogram_cache.purge(node.id)
        return total

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
