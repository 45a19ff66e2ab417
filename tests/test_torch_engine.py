"""The port's RenderEngine.render_bricked and render_cli against the JAX
package's, end to end on the CPU.

Same datasource, same camera, same LOD selection: the JAX engine runs
its Pallas sweep in interpret mode, the port's engine runs on
``device="cpu"`` (plain sweep).  atol 5e-5: the sweep's 2e-5 plus what
the bilinear screen warp adds.
"""

import os

import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import Frustum, look_at, perspective
from libre_tpu.data.datasource import DataSource, load_plugins
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.apps import render_cli
from libre_tpu_torch.core.frustum import Frustum as FrustumT
from libre_tpu_torch.data.datasource import DataSource as DataSourceT
from libre_tpu_torch.data.datasource import load_plugins as load_plugins_t
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.render.engine import RenderEngine as EngineT
from libre_tpu_torch.render.registry import create_renderer
from libre_tpu_torch.utils.image import read_image
from tests.test_bricked import make_scene

torch.set_num_threads(1)
load_plugins()
load_plugins_t()

W = H = 48


def view(eye=(0.2, 0.1, 1.4)):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    frustum = Frustum(mv, proj)
    frustum_t = FrustumT(mv, proj)
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, W, H),
        near=frustum.near,
    )
    return CameraJ(**kw), CameraT(**kw), frustum, frustum_t


SCENES = {
    # name: (uri or None for the tests/test_bricked.py scene, data range,
    #        n_planes, eye)
    "lod_scene": (None, (0.0, 1.0), 64, (0.2, 0.1, 1.4)),
    "mem_gradient": (
        "mem://#64,64,64,16?pattern=gradient", (0.0, 255.0), 64,
        (0.3, 1.3, 0.5),
    ),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_bricked_matches_jax(tmp_path, name):
    uri, rng, n_planes, eye = SCENES[name]
    if uri is None:
        _vol, ds_j = make_scene(tmp_path)
        uri = ds_j.uri
    else:
        ds_j = DataSource(uri)
    ds_t = DataSourceT(uri)
    cam_j, cam_t, frustum, frustum_t = view(eye)
    eng_j = EngineJ(ds_j, max_gpu_cache_mb=64, filter_mode="trilinear")
    eng_t = EngineT(ds_t, max_gpu_cache_mb=64, device="cpu")
    kw = dict(screen_space_error=1.0, n_planes=n_planes)
    want, stats_j = eng_j.render_bricked(
        cam_j, frustum,
        params=ParamsJ(n_samples_per_ray=n_planes, data_source_range=rng,
                       filter_mode="trilinear"),
        **kw,
    )
    params_t = ParamsT(n_samples_per_ray=n_planes, data_source_range=rng)
    got, stats_t = eng_t.render_bricked(cam_t, frustum_t, params=params_t, **kw)
    assert got.shape == (H, W, 4) and got.device.type == "cpu"
    assert stats_t.n_available == stats_j.n_available > 0
    assert stats_t.n_passes == 1 and stats_t.rendering_done
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert float(got[..., 3].max()) > 0.1

    # Steady state: the second frame hits the assembled-store cache.
    assert len(eng_t._store_cache) == 1
    again, _ = eng_t.render_bricked(cam_t, frustum_t, params=params_t, **kw)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    assert len(eng_t._store_cache) == 1


def test_unported_branches_raise(tmp_path):
    """Where the port stops, it says so instead of falling back: a
    resample type other than float32 and bfloat16 (ported: the bf16
    resample of K1 and K5) raises; a service mesh must be a
    ``parallel.mesh.Mesh`` (M9 is ported: tests/test_torch_apps.py serves
    sharded frames).
    Histograms (M6) are ported: ``collect_histogram`` merges the frame's
    bricks (tests/test_torch_histogram.py holds the bins to the JAX
    engine's)."""
    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import shearwarp as sw_t

    _cam_j, cam_t, _frustum, frustum = view()
    eng = EngineT(DataSourceT("mem://#32,32,32,16?pattern=gradient"), max_gpu_cache_mb=64,
                  device="cpu")
    _img, stats = eng.render_bricked(cam_t, frustum, screen_space_error=1.0, n_planes=16,
                                     collect_histogram=True)
    assert stats.histogram.sum == stats.n_available * 16 ** 3
    assert sw_t.ShearWarpParams(n_planes=16, compute_dtype="bfloat16").n_planes == 16
    with pytest.raises(ValueError, match="compute_dtype"):
        sw_t.ShearWarpParams(n_planes=16, compute_dtype="float16")
    with pytest.raises(TypeError, match="Mesh"):
        RenderService("mem://#32,32,32,16", mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        create_renderer("no-such-renderer")


def test_async_render_bricked_matches_jax():
    """``synchronous=False`` on a cold engine: nothing resident, then the
    uploads it started land and the frame is done, and equal to the JAX
    engine's synchronous frame (5e-5) and to the port's bit for bit."""
    uri = "mem://#32,32,32,16?pattern=gradient"
    cam_j, cam_t, frustum_j, frustum_t = view()
    kw = dict(screen_space_error=1.0, n_planes=16)
    eng = EngineT(DataSourceT(uri), max_gpu_cache_mb=64, device="cpu")
    img, stats = eng.render_bricked(cam_t, frustum_t, synchronous=False, **kw)
    assert not stats.rendering_done and stats.n_available == 0
    assert float(img.abs().max()) == 0.0
    for f in stats.pending_uploads:
        f.result(timeout=60)
    img, stats = eng.render_bricked(cam_t, frustum_t, synchronous=False, **kw)
    assert stats.rendering_done and stats.n_not_available == 0 and not stats.pending_uploads
    sync, _ = EngineT(DataSourceT(uri), max_gpu_cache_mb=64, device="cpu") \
        .render_bricked(cam_t, frustum_t, **kw)
    np.testing.assert_array_equal(img.numpy(), sync.numpy())
    want, _ = EngineJ(DataSource(uri), max_gpu_cache_mb=64, filter_mode="trilinear") \
        .render_bricked(cam_j, frustum_j, **kw)
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=5e-5)


def test_out_of_core_render_bricked_matches_jax():
    """1 MB: a 37-slot atlas and a 0.5 MB store share, short of the 64
    finest bricks and their 1 MiB store.  The frame runs in slab passes
    and matches the JAX engine's at the same budget."""
    uri = "mem://#64,64,64,16?pattern=gradient"
    cam_j, cam_t, frustum_j, frustum_t = view()
    kw = dict(screen_space_error=1.0, n_planes=16, min_lod=2)
    eng = EngineT(DataSourceT(uri), max_gpu_cache_mb=1, device="cpu")
    got, stats = eng.render_bricked(cam_t, frustum_t, **kw)
    assert stats.n_passes > 1 and stats.n_available == 64 > eng.atlas.n_slots
    want, stats_j = EngineJ(DataSource(uri), max_gpu_cache_mb=1, filter_mode="trilinear") \
        .render_bricked(cam_j, frustum_j, **kw)
    assert stats_j.n_available == 64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert float(got[..., 3].max()) > 0.1


def test_render_cli_writes_png(tmp_path, capsys):
    out = tmp_path / "out"
    rc = render_cli.main([
        "--volume", "mem://#32,32,32,16?pattern=gradient",
        "--device", "cpu", "--width", "48", "--height", "48",
        "--samples-per-ray", "64", "-o", str(out),
    ])
    assert rc == 0
    path = out / "frame_000000.png"
    assert path.exists() and os.path.getsize(path) > 0
    img = read_image(str(path))
    assert img.shape[:2] == (48, 48) and img.max() > 0
    assert "bricked renderer on cpu" in capsys.readouterr().out
