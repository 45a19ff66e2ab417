"""The port's ``RenderEngine.render`` (the ``xla`` / ``pallas-exact``
renderers) and its numpy host layer against the JAX package's, on the
CPU.

Same datasource URI, camera and LOD selection: the JAX engine runs its
gather marcher (``marcher="xla"``), the port's engine runs on
``device="cpu"`` (the plain marcher).  atol 1e-5, the marcher parity of
tests/test_torch_exact.py; the passes of a starved atlas compose to the
same image.  The port's copies of ``select_visibles``, ``DataSource`` and
``Frustum`` must give the same node ids, brick bytes and matrices;
nodes of the two packages are different classes, so sets are compared by
their integer ids.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.core.clip_planes import ClipPlanes as ClipJ
from libre_tpu.core.frustum import Frustum as FrustumJ, look_at, perspective
from libre_tpu.core.select_visibles import select_visibles as select_j
from libre_tpu.data.datasource import DataSource as DataSourceJ, load_plugins as plugins_j
from libre_tpu.ops import rays as rays_j
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.apps import render_cli
from libre_tpu_torch.core.clip_planes import ClipPlanes as ClipT
from libre_tpu_torch.core.frustum import Frustum as FrustumT
from libre_tpu_torch.core.frustum import look_at as look_at_t, perspective as perspective_t
from libre_tpu_torch.core.select_visibles import select_visibles as select_t
from libre_tpu_torch.data.datasource import DataSource as DataSourceT, load_plugins as plugins_t
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import rays as rays_t
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.render.engine import RenderEngine as EngineT
from libre_tpu_torch.render.registry import create_renderer
from libre_tpu_torch.utils.image import read_image
from tests.test_bricked import make_scene

torch.set_num_threads(1)
plugins_j()
plugins_t()

W = H = 40
ATOL = 1e-5
GRADIENT = "mem://#32,32,32,16?pattern=gradient"
CLIP = [[1.0, 0.0, 0.0, 0.2], [0.0, -0.6, 0.8, 0.25]]


def view(eye, w=W, h=H):
    proj = perspective(50.0, w / h, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    frustum_j, frustum_t = FrustumJ(mv, proj), FrustumT(mv, proj)
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w, h),
        near=frustum_t.near,
    )
    return CameraJ(**kw), CameraT(**kw), frustum_j, frustum_t


SCENES = {
    # name: (uri or None for the tests/test_bricked.py LOD store, data range,
    #        filter mode, eye, screen-space error, clip planes, spp, starve)
    "gradient_nearest": (GRADIENT, (0.0, 255.0), "nearest", (0.3, 0.2, 1.4), 1.0, None, 1, False),
    "gradient_trilinear_clip": (
        GRADIENT, (0.0, 255.0), "trilinear", (-0.4, 0.9, 1.1), 1.0, CLIP, 1, False,
    ),
    "uint16_mixed_lod": (
        "mem://#64,64,64,16?pattern=gradient&datatype=uint16", (0.0, 65535.0),
        "trilinear", (0.3, 1.3, 0.5), 1.5, None, 1, False,
    ),
    "lod_store_f32": (None, (0.0, 1.0), "trilinear", (0.2, 0.1, 1.4), 1.0, None, 1, False),
    "multipass": (GRADIENT, (0.0, 255.0), "trilinear", (0.3, 0.2, 1.4), 1.0, None, 1, True),
    "spp2": (GRADIENT, (0.0, 255.0), "trilinear", (0.3, 0.2, 1.4), 1.0, None, 2, False),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax(tmp_path, monkeypatch, name):
    uri, rng, filter_mode, eye, sse, clip, spp, starve = SCENES[name]
    if uri is None:
        uri = make_scene(tmp_path)[1].uri
    cam_j, cam_t, fr_j, fr_t = view(eye)
    # Jittered samples: both packages on the port's host jitter grid.
    make_rays = rays_j.make_rays
    monkeypatch.setattr(
        rays_j, "make_rays",
        lambda p, m, vp, sample_index=0, frag_override=None: make_rays(
            p, m, vp, sample_index,
            rays_t.jitter_frag(tuple(vp), sample_index) if sample_index else None,
        ),
    )
    eng_j = EngineJ(DataSourceJ(uri), max_gpu_cache_mb=64)
    eng_t = EngineT(DataSourceT(uri), max_gpu_cache_mb=64, device="cpu")
    if starve:
        # An atlas of 3 slots: passes of 2 bricks, the carry threaded
        # through them (GLRaycastPipeline.cpp:148-186).
        eng_t = EngineT(
            DataSourceT(uri), max_gpu_cache_mb=6 * eng_t.atlas.slot_bytes / 2**20,
            device="cpu",
        )
        assert eng_t.atlas.n_slots == 3
    kw = dict(n_samples_per_ray=64, data_source_range=rng, filter_mode=filter_mode,
              samples_per_pixel=spp)
    want, stats_j, hist_j = eng_j.render(
        cam_j, fr_j, params=ParamsJ(**kw), screen_space_error=sse,
        clip_planes=None if clip is None else ClipJ(clip), marcher="xla",
    )
    got, stats_t, hist_t = eng_t.render(
        cam_t, fr_t, params=ParamsT(**kw), screen_space_error=sse,
        clip_planes=None if clip is None else ClipT(clip),
    )
    assert got.shape == (H, W, 4) and got.device.type == "cpu" and hist_t is None
    assert stats_t.n_available == stats_j.n_available == stats_t.n_render_available > 1
    n = stats_t.n_available
    assert stats_t.n_passes == (-(-n // 2) if starve else 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got[..., 3].max()) > 0.1


def test_render_with_a_large_1dt_tf_matches_jax(tmp_path):
    """A whole frame from an 8192-entry TF (past the kernels' shared
    instances): written by ``save_1dt``, read back by the port's
    ``load_1dt`` (``.1dt`` files size the table to the data's value range),
    set as both engines' TF; the port's ``xla`` renderer against the JAX
    engine's ``render(marcher="xla")`` on two poses, max 5e-5 and mean
    1e-5 (the frames' bound of ``PERF.md`` §2)."""
    from libre_tpu_torch.ops.transfer_function import load_1dt, save_1dt
    from libre_tpu_torch.testing import tf_of_size

    path = str(tmp_path / "wide.1dt")
    save_1dt(path, tf_of_size(8192))
    tf = load_1dt(path)
    assert tf.shape == (8192, 4)
    eng_j = EngineJ(DataSourceJ(GRADIENT), max_gpu_cache_mb=64)
    eng_t = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=64, device="cpu")
    eng_j.transfer_function = jnp.asarray(tf)
    eng_t.transfer_function = torch.from_numpy(tf)
    renderer = create_renderer("xla")
    kw = dict(n_samples_per_ray=64, data_source_range=(0.0, 255.0), filter_mode="trilinear")
    for eye in ((0.3, 0.2, 1.4), (-0.4, 0.9, 1.1)):
        cam_j, cam_t, fr_j, fr_t = view(eye)
        want, _, _ = eng_j.render(cam_j, fr_j, params=ParamsJ(**kw), screen_space_error=1.0,
                                  marcher="xla")
        got = renderer.render(eng_t, cam_t, fr_t, params=ParamsT(**kw), screen_space_error=1.0)
        err = np.abs(got.numpy() - np.asarray(want))
        assert err.max() <= 5e-5 and err.mean() <= 1e-5, (err.max(), err.mean())
        assert float(got[..., 3].max()) > 0.1


def test_marchers_agree_and_params_default():
    """"auto", "pallas" and "xla" run the same marcher; params=None takes
    the Nyquist sample count and the engine's filter mode, as the JAX
    engine does; an unknown marcher raises."""
    cam_j, cam_t, fr_j, fr_t = view((0.3, 0.2, 1.4), w=24, h=24)
    eng_t = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=64, filter_mode="trilinear",
                    device="cpu")
    imgs = [eng_t.render(cam_t, fr_t, screen_space_error=2.0, marcher=m)[0]
            for m in ("auto", "pallas", "xla")]
    for img in imgs[1:]:
        np.testing.assert_array_equal(img.numpy(), imgs[0].numpy())
    eng_j = EngineJ(DataSourceJ(GRADIENT), max_gpu_cache_mb=64, filter_mode="trilinear")
    want, _, _ = eng_j.render(cam_j, fr_j, screen_space_error=2.0, marcher="xla")
    np.testing.assert_allclose(imgs[0].numpy(), np.asarray(want), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="marcher"):
        eng_t.render(cam_t, fr_t, marcher="cuda")


def test_render_unported_branches_raise():
    """Histograms (M6) are ported: ``render(collect_histogram=True)``
    returns the merged histogram of the frame's bricks (bins against the
    JAX engine's in tests/test_torch_histogram.py); the exact renderer's
    service takes a ``parallel.mesh.Mesh`` or nothing."""
    from libre_tpu_torch.apps.serve import RenderService

    _cam_j, cam_t, _fr_j, fr_t = view((0.3, 0.2, 1.4))
    eng = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=16, device="cpu")
    _img, stats, hist = eng.render(cam_t, fr_t, collect_histogram=True)
    assert hist.sum == stats.n_render_available * 16 ** 3 > 0
    with pytest.raises(TypeError, match="Mesh"):
        RenderService(GRADIENT, renderer="exact", mesh=object(), device="cpu")


def test_render_async_matches_jax():
    """``render(synchronous=False)`` on a cold engine converges, once its
    uploads land, to the synchronous frame bit for bit and to the JAX
    engine's (``marcher="xla"``) within ATOL."""
    cam_j, cam_t, fr_j, fr_t = view((0.3, 0.2, 1.4))
    params_t = ParamsT(n_samples_per_ray=64, data_source_range=(0.0, 255.0),
                       filter_mode="trilinear")
    eng = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=16, device="cpu")
    img, stats, _ = eng.render(cam_t, fr_t, params=params_t, screen_space_error=1.0,
                          synchronous=False)
    assert not stats.rendering_done and stats.n_available == 0 and stats.n_passes == 0
    for f in stats.pending_uploads:
        f.result(timeout=60)
    img, stats, _ = eng.render(cam_t, fr_t, params=params_t, screen_space_error=1.0,
                          synchronous=False)
    assert stats.rendering_done and stats.n_available > 1
    sync, _, _ = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=16, device="cpu") \
        .render(cam_t, fr_t, params=params_t, screen_space_error=1.0)
    np.testing.assert_array_equal(img.numpy(), sync.numpy())
    want, _, _ = EngineJ(DataSourceJ(GRADIENT), max_gpu_cache_mb=16).render(
        cam_j, fr_j, params=ParamsJ(n_samples_per_ray=64, data_source_range=(0.0, 255.0),
                                    filter_mode="trilinear"),
        screen_space_error=1.0, marcher="xla")
    np.testing.assert_allclose(img.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_render_cli_exact_renderers(tmp_path, capsys):
    """``render_cli --renderer xla|pallas-exact`` drives ``engine.render``
    (trilinear, as the JAX CLI) and both write the same PNG."""
    launches = exact.march_exact.launches
    pngs = []
    for renderer in ("xla", "pallas-exact"):
        out = tmp_path / renderer
        rc = render_cli.main([
            "--volume", GRADIENT, "--device", "cpu", "--renderer", renderer,
            "--width", "32", "--height", "24", "--samples-per-ray", "64",
            "--samples-per-pixel", "2", "-o", str(out),
        ])
        assert rc == 0
        assert f"{renderer} renderer on cpu" in capsys.readouterr().out
        pngs.append(read_image(str(out / "frame_000000.png")))
    assert exact.march_exact.launches == launches  # the CPU runs no kernel
    assert pngs[0].shape[:2] == (24, 32) and pngs[0].max() > 0
    np.testing.assert_array_equal(pngs[0], pngs[1])


def test_exact_renderers_pass_keywords_as_jax():
    """``pallas-exact`` keeps only engine.render's keywords; ``xla`` passes
    every keyword on (libre_tpu/render/registry.py:54-114)."""
    _cam_j, cam_t, _fr_j, fr_t = view((0.3, 0.2, 1.4), w=16, h=16)
    eng = EngineT(DataSourceT(GRADIENT), max_gpu_cache_mb=64, device="cpu")
    params = ParamsT(n_samples_per_ray=32)
    img = create_renderer("pallas-exact").render(
        eng, cam_t, fr_t, params=params, screen_space_error=2.0, n_planes=7
    )
    want, _, _ = eng.render(cam_t, fr_t, params=params, screen_space_error=2.0)
    np.testing.assert_array_equal(img.numpy(), want.numpy())
    with pytest.raises(TypeError):
        create_renderer("xla").render(eng, cam_t, fr_t, params=params, n_planes=7)


SELECT_CASES = {
    # name: (uri, eye, screen-space error, min_lod, max_lod, clip planes)
    "gradient_sse1": ("mem://#64,64,64,16?pattern=gradient", (0.3, 0.2, 1.4), 1.0, 0, 15, None),
    "gradient_sse3": ("mem://#64,64,64,16?pattern=gradient", (0.5, 0.7, 0.6), 3.0, 0, 15, None),
    "lod_band": ("mem://#64,64,64,16", (-0.2, 0.3, 1.6), 2.0, 1, 2, None),
    "clipped": ("mem://#64,64,64,16", (0.3, 0.2, 1.4), 1.0, 0, 15, CLIP),
    "anisotropic": ("mem://#96,64,48,16", (1.2, 0.5, 0.9), 1.5, 0, 15, None),
}


@pytest.mark.parametrize("name", sorted(SELECT_CASES))
def test_select_visibles_matches_jax(name):
    uri, eye, sse, lo, hi, clip = SELECT_CASES[name]
    _cam_j, _cam_t, fr_j, fr_t = view(eye)
    got = select_t(DataSourceT(uri), fr_t, H, sse, lo, hi, (0.0, 1.0),
                   None if clip is None else ClipT(clip), 0)
    want = select_j(DataSourceJ(uri), fr_j, H, sse, lo, hi, (0.0, 1.0),
                    None if clip is None else ClipJ(clip), 0)
    assert [n.id for n in got] == [n.id for n in want] and len(got) > 1


def test_frustum_matches_jax():
    proj, mv = perspective(50.0, 1.3, 0.1, 15.0), look_at([0.4, -0.3, 1.2], [0, 0, 0], [0, 1, 0])
    np.testing.assert_array_equal(perspective_t(50.0, 1.3, 0.1, 15.0), proj)
    np.testing.assert_array_equal(look_at_t([0.4, -0.3, 1.2], [0, 0, 0], [0, 1, 0]), mv)
    fj, ft = FrustumJ(mv, proj), FrustumT(mv, proj)
    for attr in ("mvp", "near", "far", "left", "right", "bottom", "top"):
        np.testing.assert_array_equal(np.asarray(getattr(ft, attr)), np.asarray(getattr(fj, attr)))


@pytest.mark.parametrize("uri", [
    "mem://#64,64,64,16?pattern=gradient",
    "mem://#48,40,32,16?datatype=float&pattern=gradient",
    "lod_store",
])
def test_datasource_matches_jax(tmp_path, uri):
    """Same volume information and the same brick bytes, node by node."""
    if uri == "lod_store":
        uri = make_scene(tmp_path)[1].uri
    ds_j, ds_t = DataSourceJ(uri), DataSourceT(uri)
    ij, it = ds_j.volume_info, ds_t.volume_info
    for attr in ("voxels", "block_size", "overlap", "maximum_block_size",
                 "world_size", "frame_range"):
        assert tuple(np.ravel(getattr(it, attr))) == tuple(np.ravel(getattr(ij, attr))), attr
    assert it.data_type.numpy_dtype == ij.data_type.numpy_dtype
    assert it.root_node.depth == ij.root_node.depth
    level = it.root_node.depth - 1
    _cam_j, _cam_t, fr_j, fr_t = view((0.3, 0.2, 1.4))
    nodes_t = select_t(ds_t, fr_t, H, 1.0, 0, 15, (0.0, 1.0), None, 0)
    nodes_j = {n.id: n for n in select_j(ds_j, fr_j, H, 1.0, 0, 15, (0.0, 1.0), None, 0)}
    assert any(n.level == level for n in nodes_t)
    for node in nodes_t:
        np.testing.assert_array_equal(ds_t.get_data(node), ds_j.get_data(nodes_j[node.id]))
        ln_t, ln_j = ds_t.get_node(node), ds_j.get_node(nodes_j[node.id])
        assert (ln_t.world_box_min, ln_t.world_box_max) == (ln_j.world_box_min, ln_j.world_box_max)
    assert [b.tobytes() for b in ds_t.get_data_batch(nodes_t[:3])] == [
        b.tobytes() for b in ds_j.get_data_batch([nodes_j[n.id] for n in nodes_t[:3]])
    ]
    assert os.path.basename(ds_t.uri) == os.path.basename(ds_j.uri)
