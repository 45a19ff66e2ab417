"""The port's sharded store sweep (``parallel/bricked_sharded.py``) and the
engine's sharded bricked frame against the JAX package's, on the CPU
(mirrors tests/test_bricked_sharded.py).

Same dense 24³ store, view and 40-plane grid as the JAX test.  The port
runs K1's plain version once per shard over meshes of repeated ``cpu``
devices; the JAX side its interpret-mode kernel.  Bounds are the JAX
test's: early exit off, every (ray × brick) factorization of 8 shards
and slab mode within 2e-5 of the one-device sweep (the port's and the
JAX package's); early exit 0.999 under 2e-3.  Engine frames: the port's
``RenderEngine(mesh=…).render_bricked`` within 5e-5 of the JAX engine's
``render_bricked_sharded`` (the sweep's 2e-5 plus the bilinear warp), in
the replicated-store and the slab mode, with ``sharded_frames`` counting
every frame that ran sharded; a mesh the viewport does not divide falls
back, with a warning, to the one-device frame.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_bricked as swb_j
from libre_tpu.ops import shearwarp_grad as swg_j
from libre_tpu.ops import transfer_function as tf_ops
from libre_tpu.ops.reference import RenderParams as ParamsJ
from libre_tpu.parallel.bricked_sharded import build_sharded_slabs as build_slabs_j
from libre_tpu.parallel.bricked_sharded import slab_ranges as slab_ranges_j
from libre_tpu.parallel.mesh import make_mesh as make_mesh_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops.reference import RenderParams as ParamsT
from libre_tpu_torch.parallel import bricked_sharded as bs
from libre_tpu_torch.parallel.mesh import make_mesh
from tests.test_bricked import fine_nodes, make_scene, upload_nodes
from tests.test_bricked_sharded import (
    AXIS, B_AXIS, BOUNDS, C_AXIS, EYE, GMAX, GMIN, K, NO_EXIT, SIGN, U_SIZE, V_SIZE,
    dense_store, single_device, view_vec,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
KW = dict(wb0=float(GMIN[B_AXIS]), wb1=float(GMAX[B_AXIS]),
          wc0=float(GMIN[C_AXIS]), wc1=float(GMAX[C_AXIS]))


def cpu_mesh(n_brick, n_ray):
    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[CPU] * (n_brick * n_ray))


@pytest.fixture(scope="module")
def setup():
    store_j, na, nc, nb = dense_store()
    tf = np.asarray(tf_ops.default_color_map(256))
    ref = single_device(store_j, jnp.asarray(tf), na, nc, nb)
    store = torch.from_numpy(interop.store_from_jax(np.asarray(store_j), (na, nc, nb)))
    return store_j, store, torch.from_numpy(tf), (na, nc, nb), ref


def sharded(mesh, store, tf, dims, early_exit=NO_EXIT, **kw):
    na, nc, nb = dims
    return bs.render_store_grid_sharded(
        mesh, store, tf, view_vec(), na_real=na, nc_real=nc, nb_real=nb, k_planes=K,
        inter_size=(V_SIZE, U_SIZE), early_exit=early_exit, **KW, **kw,
    ).numpy()


def one_device(store, tf, early_exit=NO_EXIT):
    na = store.shape[0]
    fv = torch.from_numpy(view_vec())
    tables = swb_t.sweep_tables(fv, na=na, k_planes=K, v_size=V_SIZE, u_size=U_SIZE)
    out, _t = swb_t.post_sweep(
        store, tf, tables, torch.zeros(8, 4), n_clip=0, wb=(KW["wb0"], KW["wb1"]),
        wc=(KW["wc0"], KW["wc1"]), early_exit=early_exit,
    )
    return out.numpy()


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (1, 8), (2, 4)])
def test_sharded_parity_mesh_shapes(setup, shape, monkeypatch):
    """Every (brick × ray) factorization of 8 shards reproduces the one-
    device sweep (the JAX kernel's and the port's) when early exit is
    off, with K1 once per shard."""
    _store_j, store, tf, dims, ref = setup
    calls = []
    real = swb_t.post_sweep
    monkeypatch.setattr(swb_t, "post_sweep", lambda *a, **k: calls.append(1) or real(*a, **k))
    img = sharded(cpu_mesh(*shape), store, tf, dims)
    assert len(calls) == 8
    np.testing.assert_allclose(img, ref, atol=2e-5)
    np.testing.assert_allclose(img, one_device(store, tf), atol=2e-5)


def test_sharded_slab_mode_parity(setup):
    """Slab mode: each brick-axis shard holds ONLY the store slices its
    plane range brackets (the same ranges as the JAX package's)."""
    _store_j, store, tf, dims, ref = setup
    d_k = 4
    lo, hi, slab_na = bs.slab_ranges(view_vec(), dims[0], K, d_k)
    lo_j, hi_j, slab_na_j = slab_ranges_j(view_vec(), dims[0], K, d_k)
    np.testing.assert_array_equal(lo, lo_j)
    np.testing.assert_array_equal(hi, hi_j)
    assert slab_na == slab_na_j < dims[0]
    slabs = [store[lo[d]:hi[d] + 1].clone() for d in range(d_k)]
    img = sharded(cpu_mesh(d_k, 2), slabs, tf, dims, a_base=lo)
    np.testing.assert_allclose(img, ref, atol=2e-5)
    with pytest.raises(ValueError):
        sharded(cpu_mesh(d_k, 2), slabs[:3], tf, dims, a_base=lo[:3])


def test_sharded_early_exit_bounded(setup):
    """With the default 0.999 threshold, early termination is local to a
    shard's segment; the deviation is bounded by (1 − threshold)."""
    store_j, store, tf, dims, _ = setup
    ref = single_device(store_j, jnp.asarray(tf.numpy()), *dims, early_exit=0.999)
    img = sharded(cpu_mesh(4, 2), store, tf, dims, early_exit=0.999)
    assert np.abs(img - ref).max() < 2e-3
    assert np.abs(img - one_device(store, tf, 0.999)).max() < 2e-3


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_sharded_both_march_signs(setup, sign):
    """Toward +A (the eye behind the volume) and toward −A, plane ranges
    whose seams cut inside the volume, in both the replicated and the
    slab mode: the fold equals the one-device sweep of the JAX package."""
    store_j, store, tf, dims, _ = setup
    eye = EYE * np.float32([1.0, 1.0, -sign])
    fv = swg_j.view_vector(
        world_min=GMIN, world_max=GMAX, axis=AXIS, eye=eye, sign=sign, slope_bounds=BOUNDS,
        inter_size=(V_SIZE, U_SIZE), max_samples_per_ray=K,
    )
    static = swg_j.static_view(
        na_store=store_j.shape[0], na_real=dims[0], nc_real=dims[1], nb_real=dims[2],
        k_planes=K, v_size=V_SIZE, u_size=U_SIZE, world_min=GMIN, world_max=GMAX, axis=AXIS,
        early_exit=NO_EXIT, interpret=True,
    )
    want = np.asarray(swg_j._run_kernel(store_j, jnp.asarray(tf.numpy()), jnp.asarray(fv), static)[0])
    common = dict(na_real=dims[0], nc_real=dims[1], nb_real=dims[2], k_planes=K,
                  inter_size=(V_SIZE, U_SIZE), early_exit=NO_EXIT, **KW)
    img = bs.render_store_grid_sharded(cpu_mesh(4, 2), store, tf, fv, **common).numpy()
    np.testing.assert_allclose(img, want, atol=2e-5)
    lo, hi, _ = bs.slab_ranges(fv, dims[0], K, 4)
    assert (np.diff(lo) * sign > 0).all()  # the ranges march with the sign
    slabs = [store[lo[d]:hi[d] + 1].clone() for d in range(4)]
    img = bs.render_store_grid_sharded(cpu_mesh(4, 2), slabs, tf, fv, a_base=lo, **common)
    np.testing.assert_allclose(img.numpy(), want, atol=2e-5)
    assert float(img[..., 3].max()) > 0.1


def test_sharded_rows_must_divide(setup):
    _store_j, store, tf, dims, _ = setup
    with pytest.raises(ValueError, match="divide"):
        sharded(cpu_mesh(1, 3), store, tf, dims)
    with pytest.raises(ValueError, match="divide"):
        sharded(cpu_mesh(3, 1), store, tf, dims)


def test_sharded_from_atlas_end_to_end(tmp_path):
    """lod:// datasource → atlas → per-shard assembled slabs
    (``build_sharded_slabs``) → sharded sweep, against the JAX package's
    slabs and one-device bricked renderer over the same atlas."""
    _vol, ds = make_scene(tmp_path, n=32, block=16)
    nodes, _ = fine_nodes(ds)
    atlas, slot_of = upload_nodes(ds, nodes)
    plan_j = swb_j.build_assembly_plan(ds, nodes, AXIS, slot_of, (0.0, 1.0))
    plan_t = interop.assembly_plan_from_jax(plan_j)
    atlas_t = torch.from_numpy(interop.atlas_from_jax(np.asarray(atlas.data), atlas.brick_shape))
    tf = tf_ops.default_color_map(256)
    na, nc, nb = plan_j.fine_dims
    k_planes = 48
    params = ParamsJ(n_samples_per_ray=k_planes, data_source_range=(0.0, 1.0),
                     filter_mode="trilinear", early_exit=NO_EXIT)
    swp = sw_j.ShearWarpParams(n_planes=k_planes, inter_size=(V_SIZE, U_SIZE),
                               classification="post")
    ref = np.asarray(swb_j.render_bricked_slope_grid(
        atlas.data, plan_j, jnp.asarray(tf), eye=EYE, sign=SIGN, slope_bounds=BOUNDS,
        world_min=GMIN, world_max=GMAX, params=params, swp=swp, interpret=True,
    ))
    fv = swg_j.view_vector(
        world_min=GMIN, world_max=GMAX, axis=AXIS, eye=EYE, sign=SIGN, slope_bounds=BOUNDS,
        inter_size=(V_SIZE, U_SIZE), max_samples_per_ray=params.max_samples_per_ray,
    )
    d_k = 4
    slabs, a_base = bs.build_sharded_slabs(atlas_t, plan_t, fv, k_planes, d_k)
    slabs_j, a_base_j = build_slabs_j(atlas.data, plan_j, fv, k_planes, d_k)
    want_slabs, want_base = interop.store_slabs_from_jax(
        np.asarray(slabs_j), np.asarray(a_base_j), (na, nc, nb)
    )
    np.testing.assert_array_equal(a_base, want_base)
    for got, want in zip(slabs, want_slabs):
        assert got.shape[0] < na
        np.testing.assert_allclose(got.numpy(), want[:got.shape[0]], atol=1e-6)
    img = bs.render_store_grid_sharded(
        cpu_mesh(d_k, 2), slabs, torch.from_numpy(tf), fv, na_real=na, nc_real=nc,
        nb_real=nb, k_planes=k_planes, inter_size=(V_SIZE, U_SIZE), early_exit=NO_EXIT,
        a_base=a_base, **KW,
    ).numpy()
    np.testing.assert_allclose(img, ref, atol=2e-5)


# ------------------------------------------------------------- the engine
def engine_scene(tmp_path):
    from libre_tpu.core.frustum import Frustum, look_at, perspective
    from libre_tpu.ops.reference import Camera as CameraJ
    from libre_tpu_torch.core.frustum import Frustum as FrustumT
    from libre_tpu_torch.ops.reference import Camera as CameraT

    _vol, ds = make_scene(tmp_path)
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, 48, 48), near=0.1,
    )
    return ds, CameraJ(**kw), CameraT(**kw), Frustum(mv, proj), FrustumT(mv, proj)


GRADIENT = "mem://#64,64,64,16?pattern=gradient"


@pytest.mark.parametrize("case", ["replicated", "slabs"])
def test_engine_render_bricked_sharded_matches_jax(tmp_path, case):
    """``RenderEngine(mesh=…).render_bricked`` against the JAX engine's
    ``render_bricked_sharded`` on a 2 × 4 (brick × ray) mesh: the lod://
    scene at 64 MB renders from the replicated store, cached and shared
    with the one-device path; the 64³ uint8 gradient at 1.9 MB (its 1 MiB
    store over the derived budget, its 64 bricks within the atlas) from
    one slab per brick-axis shard, assembled per view."""
    from libre_tpu.data.datasource import DataSource as DataSourceJ
    from libre_tpu.data.datasource import load_plugins as load_plugins_j
    from libre_tpu.render.engine import RenderEngine as EngineJ
    from libre_tpu_torch.data.datasource import DataSource as DataSourceT
    from libre_tpu_torch.data.datasource import load_plugins
    from libre_tpu_torch.render.engine import RenderEngine as EngineT

    load_plugins()
    load_plugins_j()
    ds, cam_j, cam_t, fr_j, fr_t = engine_scene(tmp_path)
    budget_mb, rng, planes = 64, (0.0, 1.0), 48
    if case == "slabs":
        ds, budget_mb, rng, planes = DataSourceJ(GRADIENT), 1.9, (0.0, 255.0), 64
    kw = dict(screen_space_error=1.0, n_planes=planes)
    params_j = ParamsJ(n_samples_per_ray=planes, data_source_range=rng, filter_mode="trilinear")
    params_t = ParamsT(n_samples_per_ray=planes, data_source_range=rng)
    eng_j = EngineJ(ds, max_gpu_cache_mb=budget_mb, filter_mode="trilinear")
    want, s_j = eng_j.render_bricked_sharded(
        cam_j, fr_j, make_mesh_j(n_brick=2, n_ray=4), params=params_j, **kw
    )
    eng_t = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=budget_mb, device="cpu",
                    mesh=cpu_mesh(2, 4))
    got, s_t = eng_t.render_bricked(cam_t, fr_t, params=params_t, **kw)
    assert eng_t.sharded_frames == 1 and s_t.n_passes == s_j.n_passes == 2
    assert s_t.n_available == s_j.n_available > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert float(got[..., 3].max()) > 0.1
    replicated = case == "replicated"
    assert len(eng_t._store_cache) == int(replicated)
    again, _ = eng_t.render_bricked(cam_t, fr_t, params=params_t, **kw)
    assert eng_t.sharded_frames == 2 and len(eng_t._store_cache) == int(replicated)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    single, _ = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu") \
        .render_bricked(cam_t, fr_t, params=params_t, **kw)
    assert np.abs(got.numpy() - single.numpy()).max() < 2e-3


def test_engine_sharded_fallback_and_progressive(tmp_path, caplog):
    """A viewport the ray axis does not divide falls back to the one-
    device frame with one warning; an asynchronous sharded frame renders
    the resident set, then, once its uploads land, the synchronous
    sharded frame."""
    from libre_tpu_torch.data.datasource import DataSource as DataSourceT
    from libre_tpu_torch.data.datasource import load_plugins
    from libre_tpu_torch.render.engine import RenderEngine as EngineT

    load_plugins()
    ds, _cam_j, cam_t, _fr_j, fr_t = engine_scene(tmp_path)
    kw = dict(screen_space_error=1.0, n_planes=32)
    eng = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu", mesh=cpu_mesh(1, 5))
    with caplog.at_level(logging.WARNING):
        img, _ = eng.render_bricked(cam_t, fr_t, **kw)
        eng.render_bricked(cam_t, fr_t, **kw)
    assert eng.sharded_frames == 0
    assert sum("fell back" in r.message for r in caplog.records) == 1
    single, _ = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu") \
        .render_bricked(cam_t, fr_t, **kw)
    np.testing.assert_array_equal(img.numpy(), single.numpy())

    mesh = cpu_mesh(2, 4)
    sync, s0 = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu", mesh=mesh) \
        .render_bricked(cam_t, fr_t, **kw)
    assert s0.rendering_done
    fresh = EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu", mesh=mesh)
    _img, s1 = fresh.render_bricked(cam_t, fr_t, synchronous=False, **kw)
    assert not s1.rendering_done and s1.pending_uploads
    for f in s1.pending_uploads:
        f.result(timeout=60)
    img2, s2 = fresh.render_bricked(cam_t, fr_t, synchronous=False, **kw)
    assert s2.rendering_done and fresh.sharded_frames == 2
    np.testing.assert_allclose(img2.numpy(), sync.numpy(), atol=1e-6)
    with pytest.raises(TypeError):
        EngineT(DataSourceT(ds.uri), max_gpu_cache_mb=64, device="cpu", mesh=object())
