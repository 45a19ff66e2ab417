"""The port's out-of-core slab multipass and asynchronous upload pipeline
against the JAX package's, on the CPU.

* ``make_slab_plans``: the same passes as the JAX package's for the same
  plane tables, each plane in exactly one pass;
* ``render_bricked_slope_grid`` over A-slabs of 4, 7 and 13 slices: bit
  for bit the port's own single sweep (the passes share the global plane
  grid and carry (rgb, t) from one to the next), and within 2e-5 of the
  JAX package's slabbed frame in interpret mode (the bound the JAX package
  holds its own kernel to);
* ``RenderEngine.render_bricked`` over a store larger than the derived
  budget or a set larger than the atlas: bit for bit the port's in-core
  frame of the same set, and within 5e-5 of the JAX engine's frame (the
  sweep's 2e-5 plus what the bilinear warp adds), also when one slab needs
  more bricks than the atlas holds and is paged in chunks;
* asynchronous frames of ``render_bricked`` and ``render``: not done, then
  done, then equal to the synchronous frame; ``prefetch_view``,
  ``upload_view`` and ``compute_rendering_set`` as the JAX engine's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libre_tpu.core.frustum import Frustum as FrustumJ, look_at, perspective
from libre_tpu.core.nodeid import NodeId as NodeIdJ
from libre_tpu.data.datasource import DataSource as DataSourceJ, load_plugins as plugins_j
from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_bricked as swb_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu.render.engine import compute_rendering_set as rendering_set_j
from libre_tpu_torch import interop
from libre_tpu_torch.core.frustum import Frustum as FrustumT
from libre_tpu_torch.data.datasource import DataSource as DataSourceT, load_plugins as plugins_t
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops.atlas import BrickAtlas as BrickAtlasT
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.render.engine import RenderEngine as EngineT
from libre_tpu_torch.render.engine import compute_rendering_set as rendering_set_t
from tests.test_bricked import BOUNDS, EYE, GMAX, GMIN, SIGN, fine_nodes, make_scene, upload_nodes
from tests.test_torch_assembly import mixed_set

torch.set_num_threads(1)
plugins_j()
plugins_t()

SWP_J = sw_j.ShearWarpParams(n_planes=64, inter_size=(24, 20), classification="post")
SWP_T = sw_t.ShearWarpParams(n_planes=64, inter_size=(24, 20))
PARAMS_J = ParamsJ(n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="trilinear")
PARAMS_T = ParamsT(n_samples_per_ray=64, data_source_range=(0.0, 1.0))
GRADIENT = "mem://#32,32,32,16?pattern=gradient"


def view(eye, w=48, h=48):
    proj = perspective(50.0, w / h, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w, h),
        near=0.1,
    )
    return CameraJ(**kw), CameraT(**kw), FrustumJ(mv, proj), FrustumT(mv, proj)


# ------------------------------------------------------------ slab plans
PLAN_CASES = [(32, 100, 6), (32, 64, 4), (64, 64, 7), (64, 200, 13), (20, 20, 2), (17, 50, 64)]


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("na,k_planes,max_slices", PLAN_CASES)
def test_slab_plans_match_jax(na, k_planes, max_slices, sign):
    a0, _a1, _wa, _dl, _z, _dz = swb_j.plane_tables(
        na=na, k_planes=k_planes, wa0=-0.5, wa1=0.5, eye_a=1.4 * sign, sign=sign
    )
    got = swb_t.make_slab_plans(a0, na, max_slices)
    want = swb_j.make_slab_plans(a0, na, max_slices)
    assert [dataclasses_tuple(p) for p in got] == [dataclasses_tuple(p) for p in want]


def dataclasses_tuple(p):
    return (p.a_lo, p.a_hi_incl, p.k_lo, p.k_hi)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("na,k_planes,max_slices", PLAN_CASES)
def test_slab_plans_cover_each_plane_once(na, k_planes, max_slices, sign):
    """From the port's own device tables: every plane in exactly one pass,
    in march order, each pass's slices inside its slab of ≤ max_slices."""
    fv = torch.from_numpy(swb_t.view_vector(
        world_min=GMIN, world_max=GMAX, axis=2, eye=[0.1, 0.05, 1.4 * sign], sign=sign,
        slope_bounds=BOUNDS, inter_size=(4, 4), max_samples_per_ray=64,
    ))
    tables = swb_t.sweep_tables(fv, na=na, k_planes=k_planes, v_size=4, u_size=4)
    a0 = tables.a0.numpy()
    plans = swb_t.make_slab_plans(a0, na, max_slices)
    ks = []
    for p in plans:
        ks.extend(range(p.k_lo, p.k_hi))
        assert p.a_hi_incl - p.a_lo + 1 <= max(2, max_slices)
        sl = a0[p.k_lo : p.k_hi]
        assert sl.min() >= p.a_lo
        assert np.minimum(sl + 1, na - 1).max() <= p.a_hi_incl
        np.testing.assert_array_equal(tables.a1.numpy()[p.k_lo : p.k_hi], np.minimum(sl + 1, na - 1))
    assert ks == list(range(k_planes))
    if na > max_slices:
        assert len(plans) > 1


# ----------------------------------------------------- slope grid in slabs
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_slab")
    _vol, ds32 = make_scene(tmp)
    _vol, ds64 = make_scene(tmp, n=64, block=16)
    return {"fine": (ds32, fine_nodes(ds32)[0]), "mixed": (ds64, mixed_set(ds64))}


def slope_grid_t(atlas_t, plan, tf, **kw):
    return swb_t.render_bricked_slope_grid(
        atlas_t, plan, tf, eye=EYE, sign=SIGN, slope_bounds=BOUNDS, world_min=GMIN,
        world_max=GMAX, params=PARAMS_T, swp=SWP_T, **kw,
    )


@pytest.mark.parametrize("max_slices", [4, 7, 13])
@pytest.mark.parametrize("case", ["fine", "mixed"])
def test_slope_grid_multipass(scene, case, max_slices):
    ds, nodes = scene[case]
    atlas, slot_of = upload_nodes(ds, nodes)
    plan_t = swb_t.build_assembly_plan(ds, nodes, 2, slot_of, (0.0, 1.0))
    atlas_t = torch.from_numpy(interop.atlas_from_jax(np.asarray(atlas.data), atlas.brick_shape))
    tf = tf_j.default_color_map(256)
    tf_t = torch.from_numpy(tf)
    single = slope_grid_t(atlas_t, plan_t, tf_t)
    got = slope_grid_t(atlas_t, plan_t, tf_t, max_slab_slices=max_slices)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert float(got[..., 3].max()) > 0.1
    store = swb_t.assemble_store(atlas_t, plan_t)
    np.testing.assert_array_equal(slope_grid_t(atlas_t, plan_t, tf_t, store=store).numpy(),
                                  single.numpy())
    if case == "fine":
        plan_j = swb_j.build_assembly_plan(ds, nodes, 2, slot_of, (0.0, 1.0))
        want = np.asarray(swb_j.render_bricked_slope_grid(
            atlas.data, plan_j, jnp.asarray(tf), eye=EYE, sign=SIGN, slope_bounds=BOUNDS,
            world_min=GMIN, world_max=GMAX, params=PARAMS_J, swp=SWP_J, interpret=True,
            max_slab_slices=max_slices,
        ))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_chunk_union_matches_jax(scene):
    """The reference's chunked paging combines the assemblies of chunks of
    a slab's bricks by maximum.  On a finest-level set that is the whole
    store exactly; where two adjacent coarser bricks fall into different
    chunks, each chunk's upsample misses the other's taps at their seam
    (ROADMAP queue 3).  The port's union equals the JAX package's."""
    ds, fine = scene["mixed"]
    level = fine[-1].level + 1
    coarse = [NodeIdJ.from_coords(level - 1, (0, 0, 0)), NodeIdJ.from_coords(level - 1, (1, 0, 0))]
    nodes = [coarse[0]] + [
        n for n in fine_nodes(ds)[0] if not (n.position[1] < 2 and n.position[2] < 2)
    ] + [coarse[1]]
    atlas, slot_of = upload_nodes(ds, fine_nodes(ds)[0] + coarse)
    atlas_t = torch.from_numpy(interop.atlas_from_jax(np.asarray(atlas.data), atlas.brick_shape))
    for chunks_of, exact in ((fine_nodes(ds)[0], True), (nodes, False)):
        whole = swb_t.assemble_store(
            atlas_t, swb_t.build_assembly_plan(ds, chunks_of, 2, slot_of, (0.0, 1.0))
        )
        union_t = union_j = None
        for cs in range(0, len(chunks_of), 20):
            chunk = chunks_of[cs : cs + 20]
            part_t = swb_t.assemble_store(
                atlas_t, swb_t.build_assembly_plan(ds, chunk, 2, slot_of, (0.0, 1.0))
            )
            plan_j = swb_j.build_assembly_plan(ds, chunk, 2, slot_of, (0.0, 1.0))
            part_j = interop.store_from_jax(
                np.asarray(swb_j.assemble_store(atlas.data, plan_j)), plan_j.fine_dims
            )
            union_t = part_t if union_t is None else torch.maximum(union_t, part_t)
            union_j = part_j if union_j is None else np.maximum(union_j, part_j)
        np.testing.assert_allclose(union_t.numpy(), union_j, atol=1e-5)
        seam = float((union_t - whole).abs().max())
        assert seam == 0.0 if exact else seam <= 0.05


# ------------------------------------------------------ engine, out of core
def engines(uri, budget_mb, **kw):
    return (EngineJ(DataSourceJ(uri), max_gpu_cache_mb=budget_mb, filter_mode="trilinear", **kw),
            EngineT(DataSourceT(uri), max_gpu_cache_mb=budget_mb, device="cpu", **kw))


OOC_CASES = {
    # name: (uri or None for the tests/test_bricked.py 32³ scene in 8³
    #        blocks, data range, eye, render_bricked keywords, budget in MB
    #        or in atlas slots)
    "gradient_axis_x": ("mem://#64,64,64,16?pattern=gradient", (0.0, 255.0), (1.3, 0.4, -0.3),
                        dict(min_lod=2, n_planes=48), ("mb", 1)),
    "lod_scene_oblique": (None, (0.0, 1.0), (1.1, 0.5, 0.9), dict(n_planes=48), ("slots", 20)),
    "lod_scene_axis_x": (None, (0.0, 1.0), (1.4, 0.2, 0.1), dict(n_planes=40), ("slots", 12)),
}


def budget_for(spec, slot_bytes):
    kind, n = spec
    return n if kind == "mb" else n * slot_bytes * 2 / 2**20


@pytest.mark.parametrize("case", sorted(OOC_CASES))
def test_engine_out_of_core_frame(tmp_path, case):
    uri, rng, eye, kw, spec = OOC_CASES[case]
    if uri is None:
        uri = make_scene(tmp_path, n=32, block=8)[1].uri
    cam_j, cam_t, fr_j, fr_t = view(eye)
    kw = dict(screen_space_error=1.0, **kw)
    _eng_j, big = engines(uri, 64)
    whole, s_big = big.render_bricked(cam_t, fr_t, params=ParamsT(
        n_samples_per_ray=kw["n_planes"], data_source_range=rng), **kw)
    budget = budget_for(spec, big.atlas.slot_bytes)
    eng_j, small = engines(uri, budget)
    got, stats = small.render_bricked(cam_t, fr_t, params=ParamsT(
        n_samples_per_ray=kw["n_planes"], data_source_range=rng), **kw)
    assert s_big.n_passes == 1 and stats.n_passes > 1
    assert stats.n_available == s_big.n_available
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    assert float(got[..., 3].max()) > 0.1
    want, s_j = eng_j.render_bricked(cam_j, fr_j, params=ParamsJ(
        n_samples_per_ray=kw["n_planes"], data_source_range=rng, filter_mode="trilinear"), **kw)
    assert s_j.n_available == stats.n_available
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    # The frame's bricks went through the atlas in slabs: later slabs
    # evicted earlier ones where the atlas holds fewer than the set.
    if stats.n_available > small.atlas.n_slots:
        assert small.texture_cache.statistics.evictions > 0


def test_slab_larger_than_atlas_pages_in_chunks(tmp_path):
    """An atlas of 6 slots, fewer than one block layer of the set: each
    slab is paged in chunks of 5 bricks, evicting mid-slab, and the frame
    is the in-core frame bit for bit (modelled on
    tests/test_device_budget.py::test_slab_larger_than_atlas_chunks_and_matches)."""
    _vol, ds = make_scene(tmp_path, n=32, block=8)
    cam_j, cam_t, fr_j, fr_t = view((0.2, 0.1, 1.4))
    eng_j, big = EngineJ(ds, max_gpu_cache_mb=64, filter_mode="trilinear"), EngineT(
        DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu")
    kw = dict(screen_space_error=1.0, n_planes=48)
    whole, s_big = big.render_bricked(cam_t, fr_t, params=PARAMS_T, **kw)
    tiny = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=6.4 * big.atlas.slot_bytes * 2 / 2**20,
                   device="cpu")
    assert tiny.atlas.n_slots == 6 < s_big.n_available
    copies = []
    real_copy = tiny.atlas._copy
    tiny.atlas._copy = lambda slots, host: (copies.append(list(slots)), real_copy(slots, host))
    got, stats = tiny.render_bricked(cam_t, fr_t, params=PARAMS_T, **kw)
    assert stats.n_passes > 1 and tiny.texture_cache.statistics.evictions > 0
    assert max(len(c) for c in copies) <= 5 and len(copies) > stats.n_passes
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    want, _ = eng_j.render_bricked(cam_j, fr_j, params=PARAMS_J, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# ------------------------------------------------------------------ async
def converge(render, n=50):
    """Render until ``rendering_done``, reading every upload future in
    between; returns (first stats, last image, last stats)."""
    img, stats = render()
    first = stats
    for _ in range(n):
        for f in stats.pending_uploads:
            f.result(timeout=60)
        if stats.rendering_done:
            return first, img, stats
        img, stats = render()
    raise AssertionError(f"not done after {n} frames")


@pytest.mark.parametrize("budget_mb", [64, 1.9])
def test_async_render_bricked_converges(budget_mb):
    """A cold engine's first asynchronous frame has nothing resident; the
    uploads it starts land; the next frame is done and is the synchronous
    frame bit for bit.  At 1.9 MB the atlas (72 slots) holds the 64
    bricks but the derived budget not their 1 MiB store: both frames are
    out of core."""
    uri = "mem://#64,64,64,16?pattern=gradient"
    _cam_j, cam_t, _fr_j, fr_t = view((0.3, 0.2, 1.5))
    kw = dict(screen_space_error=1.0, n_planes=32, min_lod=2)
    sync, s_sync = EngineT(DataSourceT(uri), max_gpu_cache_mb=budget_mb, device="cpu") \
        .render_bricked(cam_t, fr_t, **kw)
    assert s_sync.n_passes == (1 if budget_mb == 64 else 2)
    cold = EngineT(DataSourceT(uri), max_gpu_cache_mb=budget_mb, device="cpu")
    first, img, stats = converge(
        lambda: cold.render_bricked(cam_t, fr_t, synchronous=False, **kw))
    assert not first.rendering_done and first.n_available == 0
    assert first.n_not_available == s_sync.n_available and len(first.pending_uploads) > 0
    assert stats.rendering_done and stats.n_not_available == 0
    assert stats.n_passes == s_sync.n_passes
    np.testing.assert_array_equal(img.numpy(), sync.numpy())


def test_async_render_converges_and_falls_back_to_ancestors():
    """``render(synchronous=False)``: the first frame renders nothing, a
    frame with only the root resident renders the root in place of its
    descendants, and the frame after the uploads land is the synchronous
    frame bit for bit."""
    _cam_j, cam_t, _fr_j, fr_t = view((0.3, 0.2, 1.4), w=32, h=32)
    params = ParamsT(n_samples_per_ray=64, data_source_range=(0.0, 255.0),
                     filter_mode="trilinear")
    kw = dict(params=params, screen_space_error=1.0)
    sync, s_sync, _ = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=64, device="cpu") \
        .render(cam_t, fr_t, **kw)
    cold = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=64, device="cpu")
    visibles = cold.select(fr_t, 32, 1.0)
    root = visibles[0].root()
    for e in cold._upload_nodes([root]):
        e.unpin()
    img, stats, _ = cold.render(cam_t, fr_t, synchronous=False, **kw)
    assert not stats.rendering_done and stats.n_available == 1
    assert stats.n_passes == 1 and float(img[..., 3].max()) > 0.0
    first, img, stats = converge(
        lambda: cold.render(cam_t, fr_t, synchronous=False, **kw)[:2])
    assert stats.rendering_done and stats.n_available == s_sync.n_available > 1
    np.testing.assert_array_equal(img.numpy(), sync.numpy())


def test_async_uploads_batched_once(monkeypatch):
    """An asynchronous frame uploads its missing bricks in batches of
    ``UPLOAD_BATCH`` on the pool; a frame rendered while they are under
    way starts no second upload of them."""
    import threading

    from libre_tpu_torch.render import engine as engine_t

    monkeypatch.setattr(engine_t, "UPLOAD_BATCH", 8)
    _cam_j, cam_t, _fr_j, fr_t = view((0.3, 0.2, 1.5))
    kw = dict(screen_space_error=1.0, n_planes=16, min_lod=2)
    eng = EngineT(DataSourceT("mem://#64,64,64,16?pattern=gradient"), max_gpu_cache_mb=64,
                  n_upload_threads=1, device="cpu")
    gate = threading.Event()
    blocker = eng._upload_pool.submit(gate.wait, 60)
    _img, first = eng.render_bricked(cam_t, fr_t, synchronous=False, **kw)
    _img, second = eng.render_bricked(cam_t, fr_t, synchronous=False, **kw)
    gate.set()
    assert blocker.result(timeout=60)
    assert first.n_not_available == 64 and len(first.pending_uploads) == 8
    assert second.n_not_available == 64 and second.pending_uploads == []
    for f in first.pending_uploads:
        f.result(timeout=60)
    _img, third = eng.render_bricked(cam_t, fr_t, synchronous=False, **kw)
    assert third.rendering_done and not eng._uploading
    assert eng.texture_cache.statistics.object_count == 64


# ---------------------------------------------------- look-ahead, fallback
def test_prefetch_view_and_upload_view():
    """As tests/test_engine.py::test_camera_path_lookahead_prefetch_and_upload,
    and the same count of bricks as the JAX engine uploads."""
    cam_j, cam_t, fr_j, fr_t = view((0.3, 0.2, 1.5), w=64, h=64)
    eng_j, eng = engines("mem://#32,32,32,16?pattern=gradient&datatype=uint8", 64)
    futs = eng.prefetch_view(fr_t, 64, screen_space_error=2.0)
    for f in futs:
        f.result(timeout=60)
    visibles = eng.select(fr_t, 64, 2.0)
    assert visibles and all(n.id in eng.data_cache for n in visibles)
    assert not any(eng.is_resident(n) for n in visibles)
    n_up = eng.upload_view(fr_t, 64, screen_space_error=2.0)
    assert n_up == len(visibles) == eng_j.upload_view(fr_j, 64, screen_space_error=2.0)
    assert all(eng.is_resident(n) for n in visibles)
    for n in visibles:
        brick = eng.atlas.gather([eng.texture_cache.get(n.id).value])[0]
        np.testing.assert_array_equal(brick.numpy(), eng.datasource.get_data(n))
    assert eng.upload_view(fr_t, 64, screen_space_error=2.0) == 0
    assert eng.prefetch_view(fr_t, 64, screen_space_error=2.0) == []


def test_compute_rendering_set_matches_jax():
    """The ancestor fallback (RenderingSetGeneratorFilter.ipp:27-134), as
    tests/test_engine.py::test_rendering_set_ancestor_fallback, on the
    same visibles and residency in both packages."""
    _cam_j, _cam_t, fr_j, fr_t = view((0.3, 0.2, 1.5), w=64, h=64)
    uri = "mem://#64,64,64,16?pattern=gradient"
    eng_j, eng_t = engines(uri, 64)
    vis_t = eng_t.select(fr_t, 64, 1.0)
    vis_j = eng_j.select(fr_j, 64, 1.0)
    assert [n.id for n in vis_t] == [n.id for n in vis_j] and len(vis_t) > 8
    root = vis_t[0].root().id
    some_parent = vis_t[0].parent().id
    half = {n.id for n in vis_t[::2]}
    for loaded in (set(), {root}, {root, some_parent}, half, half | {root},
                   {n.id for n in vis_t}):
        got, done_t = rendering_set_t(vis_t, lambda n: n.id in loaded)
        want, done_j = rendering_set_j(vis_j, lambda n: n.id in loaded)
        assert [n.id for n in got] == [n.id for n in want] and done_t == done_j
    got, done = rendering_set_t(vis_t, lambda n: n.id == root)
    assert [n.id for n in got] == [root] and not done
    assert rendering_set_t(vis_t, lambda n: False) == ([], False)


def test_atlas_upload_parts_on_one_stream():
    """``upload_many`` = ``_stack`` → ``_pinned`` → ``_copy``; a CPU atlas
    has no stream, and a sequence of bricks stacks like one array."""
    atlas = BrickAtlasT(4, (2, 3, 4), torch.uint8, "cpu")
    assert atlas.stream is None
    bricks = [np.full((2, 3, 4), i, np.uint8) for i in range(3)]
    atlas.upload_many([2, 0, 3], bricks)
    np.testing.assert_array_equal(atlas.gather([2, 0, 3]).numpy(), np.stack(bricks))
    with pytest.raises(ValueError):
        atlas.upload_many([1], [np.zeros((2, 3, 5), np.uint8)])
