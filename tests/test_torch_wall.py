"""The multi-view wall on the CPU: the port's ``RenderEngine.render_wall``
against the JAX engine's (its store frames in interpret mode), the 1x2 and
2x2 layouts of ``benchmarks/demo_wall.py`` on ``mem://#32,32,32,16`` in a
64×64 canvas (frames max 5e-5, mean 1e-5, ``PERF.md`` §2); every tile bit
for bit the port's sequential ``render_bricked`` of its view; the two
``ValueError`` cases of the JAX method (a view with an empty rendering
set, a view too large for the single-store path); the service's 2x2 frame
through the wall, and a too-large view taking the sequential loop.
"""

import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import Frustum as FrustumJ
from libre_tpu.data.datasource import DataSource as DataSourceJ
from libre_tpu.data.datasource import load_plugins as plugins_j
from libre_tpu.ops.reference import Camera as CameraJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.apps.serve import RenderService
from libre_tpu_torch.benchmarks.demo_wall import layouts, make_view
from libre_tpu_torch.data.datasource import DataSource as DataSourceT
from libre_tpu_torch.data.datasource import load_plugins as plugins_t
from libre_tpu_torch.render.engine import RenderEngine as EngineT

torch.set_num_threads(1)
plugins_j()
plugins_t()

URI = "mem://#32,32,32,16?pattern=gradient"
SIZE = 64
N_PLANES = 32
FRAME_MAX, FRAME_MEAN = 5e-5, 1e-5
TINY_MB = 0.1  # a derived budget under the 32^3 store (128 KB): off the single-store path


def port_views(layout):
    return [(*make_view(vw, vh, az), (dx, dy)) for dx, dy, vw, vh, az in layouts(SIZE, SIZE)[layout]]


def jax_views(views):
    return [
        (CameraJ(inv_proj=c.inv_proj, inv_mv=c.inv_mv, viewport=c.viewport, near=c.near),
         FrustumJ(f.mv, f.proj), off)
        for c, f, off in views
    ]


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_wall_matches_jax_and_tiles_are_sequential_frames(layout):
    views = port_views(layout)
    eng_t = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, filter_mode="trilinear", device="cpu")
    eng_j = EngineJ(DataSourceJ(URI), max_gpu_cache_mb=64, filter_mode="trilinear")
    canvas, stats = eng_t.render_wall(views, (SIZE, SIZE), n_planes=N_PLANES, screen_space_error=1.0)
    want, stats_j = eng_j.render_wall(jax_views(views), (SIZE, SIZE), n_planes=N_PLANES,
                                      screen_space_error=1.0)
    assert canvas.shape == (SIZE, SIZE, 4) and canvas.device.type == "cpu"
    d = np.abs(canvas.numpy() - np.asarray(want))
    assert d.max() <= FRAME_MAX and d.mean() <= FRAME_MEAN, (d.max(), d.mean())
    assert [s.n_available for s in stats] == [s.n_available for s in stats_j]
    for cam, fr, (dx, dy) in views:
        vw, vh = cam.viewport[2:]
        img, _ = eng_t.render_bricked(cam, fr, n_planes=N_PLANES, screen_space_error=1.0)
        assert torch.equal(canvas[dy : dy + vh, dx : dx + vw], img)
        assert float(img[..., 3].max()) > 0.05
    assert len(eng_t._store_cache) >= 1


def test_wall_raises_where_jax_does():
    """An empty rendering set (a view that looks away from the volume) and
    a view whose store is over the derived budget: both engines raise a
    ``ValueError`` before drawing."""
    away = build_camera(32, 32, (0.0, 0.0, 3.0), (0.0, 0.0, 6.0))
    views = port_views("1x2")
    eng_t = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
    eng_j = EngineJ(DataSourceJ(URI), max_gpu_cache_mb=64)
    empty = [views[0], (*away, (32, 0))]
    with pytest.raises(ValueError, match="empty"):
        eng_t.render_wall(empty, (SIZE, SIZE), n_planes=N_PLANES)
    with pytest.raises(ValueError, match="empty"):
        eng_j.render_wall(jax_views(empty), (SIZE, SIZE), n_planes=N_PLANES)
    small_t = EngineT(DataSourceT(URI), max_gpu_cache_mb=TINY_MB, device="cpu")
    small_j = EngineJ(DataSourceJ(URI), max_gpu_cache_mb=TINY_MB)
    with pytest.raises(ValueError, match="too large"):
        small_t.render_wall(views, (SIZE, SIZE), n_planes=N_PLANES, screen_space_error=1.0)
    with pytest.raises(ValueError, match="too large"):
        small_j.render_wall(jax_views(views), (SIZE, SIZE), n_planes=N_PLANES,
                            screen_space_error=1.0)
    plan, why = small_t.plan_wall(views, (SIZE, SIZE), n_planes=N_PLANES, screen_space_error=1.0)
    assert plan == [] and "too large" in why


def _counting_draw(engine):
    calls = []
    real = engine.draw_wall

    def draw_wall(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    engine.draw_wall = draw_wall
    return calls


def test_service_2x2_frame_is_the_wall_canvas():
    """The service's 2x2 frame goes through the wall (one draw) and equals
    the engine's ``render_wall`` canvas over the same views bit for bit;
    its histogram is that of view 0's rendering set."""
    svc = RenderService(URI, width=SIZE, height=SIZE, port=0, device="cpu")
    svc.server.params["synchronous"] = True
    svc.server.params["sse"] = 1.0
    svc.layout = "2x2"
    draws = _counting_draw(svc.engine)
    frame = svc.render_frame()
    assert len(draws) == 1
    kw = {k: v for k, v in svc.frame_keywords().items() if k != "synchronous"}
    views = [(*svc.view_camera(vw, vh, az), (dx, dy)) for dx, dy, vw, vh, az in svc._layout_views()]
    canvas, _ = svc.engine.render_wall(views, (SIZE, SIZE), **kw)
    np.testing.assert_array_equal(frame, canvas.numpy())
    assert float(frame[..., 3].max()) > 0.05
    plan, _ = svc.engine.plan_wall(views, (SIZE, SIZE), **kw)
    assert svc._histogram["bins"] == svc.engine.accumulate_histogram(plan[0].nodes).bins.tolist()


def test_service_too_large_view_takes_the_sequential_loop():
    """With the derived budget under a view's store the wall's test fails
    before any draw and the service renders the views one by one (slab
    passes), each tile the engine's own ``render_bricked`` frame."""
    svc = RenderService(URI, width=SIZE, height=SIZE, port=0, device="cpu",
                        max_gpu_cache_mb=TINY_MB)
    svc.server.params["synchronous"] = True
    svc.server.params["sse"] = 1.0
    svc.layout = "2x2"
    draws = _counting_draw(svc.engine)
    frame = svc.render_frame()
    assert draws == []
    kw = svc.frame_keywords()
    for dx, dy, vw, vh, az in svc._layout_views():
        cam, fr = svc.view_camera(vw, vh, az)
        img, stats = svc.engine.render_bricked(cam, fr, **kw)
        assert stats.n_passes > 1
        np.testing.assert_array_equal(frame[dy : dy + vh, dx : dx + vw], img.numpy())
