"""The port's apps and their host modules against the JAX package's, on
the CPU (modelled on tests/test_apps.py, tests/test_colormap.py and
tests/test_config_settings.py).

* the steering server: the same requests give the same JSON from both
  packages' servers, the web UI is the port's own copy of the page;
* ``KeyboardHandler``, ``PointerHandler`` and ``EventMapper``, the
  settings classes and ``FrameData``'s tree, and the control-point
  ``ColorMap``: the same operations give the same state (1e-6);
* ``batch``: frame partitioning, the watchdog, ``--dry-run`` and the
  jobs' command line (the port's ``render_cli``);
* ``convert``: the LOD store the port writes holds the bricks the JAX
  ``convert`` writes;
* ``RenderService`` against the JAX service (``mesh=None``; the JAX one
  would shard over the 8 virtual CPU devices): frames within 5e-5 max and
  1e-5 mean for ``bricked`` and ``exact``, the histogram JSON exactly
  equal; the 2×2 layout's quadrants against the JAX engine's frame at
  each quadrant's camera, and the canvas against the JAX service's (its
  wall); async converging to sync; the progressive redraw; the endpoints
  over HTTP; the steering client against a running service.
"""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from libre_tpu.apps import batch as batch_j
from libre_tpu.apps import convert as convert_j
from libre_tpu.apps.serve import RenderService as ServiceJ
from libre_tpu.apps.steering import SteeringServer as ServerJ
from libre_tpu.core import events as events_j
from libre_tpu.core import settings as settings_j
from libre_tpu.core.frustum import Frustum as FrustumJ
from libre_tpu.data.datasource import DataSource as DataSourceJ, load_plugins as plugins_j
from libre_tpu.ops import colormap as cm_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import Camera as CameraJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.apps import batch as batch_t
from libre_tpu_torch.apps import convert as convert_t
from libre_tpu_torch.apps import steering_client
from libre_tpu_torch.apps.serve import RenderService as ServiceT
from libre_tpu_torch.apps.steering import SteeringServer as ServerT
from libre_tpu_torch.core import events as events_t
from libre_tpu_torch.core import settings as settings_t
from libre_tpu_torch.core.signalled import SignalledVariable
from libre_tpu_torch.data.datasource import DataSource as DataSourceT, load_plugins as plugins_t
from libre_tpu_torch.ops import colormap as cm_t
from libre_tpu_torch.ops import transfer_function as tf_t
from libre_tpu_torch.utils.image import encode_jpeg

torch.set_num_threads(1)
plugins_j()
plugins_t()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
URI = "mem://#32,32,32,8?pattern=gradient&datatype=uint8"
FRAME_MAX, FRAME_MEAN = 5e-5, 1e-5


def _req(url, method="GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        ct = resp.headers.get("Content-Type", "")
        raw = resp.read()
    return json.loads(raw) if "json" in ct else raw


def _base(server):
    host, port = server.address
    assert host == "127.0.0.1"
    return f"http://{host}:{port}"


# ------------------------------------------------------------- steering
STEERING_REQUESTS = [
    ("PUT", "/camera", {"position": [1, 2, 3]}),
    ("PUT", "/camera", {"lookat": [0, 0, 0]}),
    ("PUT", "/colormap", {"rgba": [[0, 0, 0, 0], [0.5, 0.25, 1, 1]]}),
    ("PUT", "/clip-planes", {"planes": [[1, 0, 0, 0.25], [0, 0.6, 0.8, -0.1]]}),
    ("PUT", "/params", {"sse": 1.5, "max_lod": 3}),
    ("PUT", "/frame", {"frame_number": 42}),
    ("PUT", "/nowhere", {}),
    ("PUT", "/layout", {"name": "2x2"}),
]
STEERING_GETS = ["/camera", "/colormap", "/params", "/frame", "/histogram", "/layout",
                 "/statistics", "/nowhere"]


def _drive(server_cls, settings_mod):
    fd = settings_mod.FrameData()
    changes = []
    server = server_cls(
        fd,
        render_jpeg=lambda: encode_jpeg(np.zeros((8, 8, 4), np.float32)),
        get_histogram=lambda: {"bins": [1, 2, 3], "min": 0.0, "max": 255.0},
        get_statistics=lambda: {"data_cache": {"hits": 7}},
        on_change=lambda: changes.append(1),
    ).start()
    base = _base(server)
    out = []
    try:
        for method, path, body in STEERING_REQUESTS:
            try:
                out.append(_req(base + path, method, body))
            except urllib.error.HTTPError as err:
                out.append((err.code, json.loads(err.read())))
        for path in STEERING_GETS:
            try:
                out.append(_req(base + path))
            except urllib.error.HTTPError as err:
                out.append((err.code, json.loads(err.read())))
        jpeg = _req(base + "/image-jpeg", "POST", {})
        assert jpeg[:2] == b"\xff\xd8"  # JPEG SOI
        out.append(_req(base + "/exit", "POST", {}))
    finally:
        server.stop()
    return out, fd, len(changes)


def test_steering_server_roundtrip():
    """The same requests to both packages' servers: the same JSON back,
    the same FrameData behind them, the same change notifications."""
    got, fd_t, n_t = _drive(ServerT, settings_t)
    want, fd_j, n_j = _drive(ServerJ, settings_j)
    assert got == want and n_t == n_j == 6
    assert got[STEERING_REQUESTS.index(("PUT", "/layout", {"name": "2x2"}))] == (
        503, {"error": "no layouts"})
    np.testing.assert_allclose(fd_t.camera_settings.get_modelview_matrix(),
                               fd_j.camera_settings.get_modelview_matrix(), atol=1e-6)
    np.testing.assert_array_equal(fd_t.render_settings.clip_planes.as_array(),
                                  fd_j.render_settings.clip_planes.as_array())
    assert fd_t.render_settings.color_map.shape == (2, 4)
    assert fd_t.frame_settings.frame_number == 42


def test_steering_web_ui_served():
    """GET / serves the port's own copy of the page; GET /colormap gives
    the current transfer function for the editor."""
    fd = settings_t.FrameData()
    server = ServerT(fd).start()
    base = _base(server)
    try:
        page = _req(f"{base}/")
        with open(os.path.join(ROOT, "libre_tpu_torch", "apps", "webui.html"), "rb") as f:
            assert page == f.read()
        assert b"libre_tpu" in page and b"tfcanvas" in page
        arr = np.asarray(_req(f"{base}/colormap")["rgba"], np.float32)
        assert arr.shape == (256, 4)
        np.testing.assert_allclose(arr, fd.render_settings.color_map, atol=1e-6)
    finally:
        server.stop()


# --------------------------------------------------------------- events
def test_keyboard_handler():
    fds, resets = [], []
    for mod, smod in ((events_t, settings_t), (events_j, settings_j)):
        fd = smod.FrameData()
        kh = mod.KeyboardHandler(fd, reset_camera=lambda: resets.append(1))
        handled = [kh(k) for k in "5+--9+ispp q"]
        fds.append((fd, handled))
    (fd_t, h_t), (fd_j, h_j) = fds
    assert h_t == h_j and h_t[-1] is False and resets == [1, 1]
    for attr in ("frame_settings", "render_settings"):
        for key in ("max_tree_depth", "statistics", "show_info", "screenshot_number"):
            a, b = getattr(fd_t, attr), getattr(fd_j, attr)
            assert getattr(a, key, None) == getattr(b, key, None)
    assert fd_t.render_settings.max_tree_depth == 10


def test_pointer_handler():
    mvs = []
    for mod, smod in ((events_t, settings_t), (events_j, settings_j)):
        fd = smod.FrameData()
        ph = mod.PointerHandler(fd)
        out = [ph.motion(10, 5, mod.BUTTON_ORBIT), ph.motion(0, -10, mod.BUTTON_DOLLY),
               ph.motion(3, 4, mod.BUTTON_PAN), ph.wheel(0, 1), ph.motion(1, 1, 9)]
        mvs.append((out, fd.camera_settings.get_modelview_matrix()))
    assert mvs[0][0] == mvs[1][0]
    np.testing.assert_allclose(mvs[0][1], mvs[1][1], atol=1e-6)
    assert not np.allclose(mvs[0][1], np.eye(4))


def test_event_mapper():
    for mod in (events_t, events_j):
        m = mod.EventMapper(factory=lambda eid: (lambda: True) if eid == 7 else None)
        assert m.register_event(7)
        assert not m.register_event(7)  # duplicate
        assert m.handle_event(7)
        assert not m.handle_event(8)
        assert m.unregister_event(7) and not m.unregister_event(7)


# ------------------------------------------------------------- settings
def _settings_run(mod):
    cam = mod.CameraSettings()
    seen = []
    cam.on_changed(lambda m: seen.append(m.copy()))
    cam.set_camera_position([1.0, 2.0, 3.0])
    cam.spin_model(0.3, 0.2)
    cam.spin_model(0.0, 0.0)  # no-op, no notification
    cam.move_camera(0.5, 0.0, -0.5)
    cam.set_camera_look_at([0.0, 0.0, 0.0])
    cam.set_camera_position([0.0, 2.0, 0.0])
    cam.set_camera_look_at([0.0, 0.0, 0.0])  # at the pole: `up` nudged
    fd = mod.FrameData()
    fd.camera_settings.set_modelview_matrix(cam.get_modelview_matrix())
    fd.frame_settings.frame_number = 7
    fd.frame_settings.toggle_info()
    fd.frame_settings.toggle_statistics()
    fd.frame_settings.make_screenshot()
    fd.volume_settings.uri = "mem://#32,32,32,16"
    fd.render_settings.clip_planes.clear()
    tree = fd.as_pytree()
    fd2 = mod.FrameData()
    fd2.update_pytree(tree)
    return seen, tree, fd2.as_pytree(), fd


def test_settings_match_jax():
    seen_t, tree_t, back_t, fd_t = _settings_run(settings_t)
    seen_j, tree_j, back_j, fd_j = _settings_run(settings_j)
    assert len(seen_t) == len(seen_j) == 6
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for tree in (back_t, tree_j, back_j):
        assert tree.keys() == tree_t.keys()
    for key in tree_t:
        for other in (back_t, tree_j):
            if isinstance(tree_t[key], np.ndarray):
                np.testing.assert_allclose(tree_t[key], other[key], atol=1e-6)
            else:
                assert tree_t[key] == other[key]
    for attr in ("screenshot_number", "statistics", "show_info", "grab_frame"):
        assert getattr(fd_t.frame_settings, attr) == getattr(fd_j.frame_settings, attr)
    rs = settings_t.RenderSettings()
    np.testing.assert_array_equal(rs.color_map, settings_j.RenderSettings().color_map)
    rs.color_map = rs.color_map * 0
    rs.reset_color_map()
    np.testing.assert_array_equal(rs.color_map, tf_t.default_color_map())
    assert settings_t.ApplicationSettings().renderer == settings_j.ApplicationSettings().renderer
    fd_t.frame_settings.reset()
    assert fd_t.frame_settings.frame_number == 0xFFFFFFFF


def test_signalled_variable():
    seen = []
    v = SignalledVariable(1, seen.append)
    v.set(2)
    v.set(3)
    assert seen == [2, 3] and v.get() == 3
    v.on_changed(lambda x: seen.append(-x))
    v.set(4)
    assert seen == [2, 3, -4]


# ------------------------------------------------------------- colormap
def _colormap_run(mod, tmp_path, tag):
    cm = mod.ColorMap({"red": [(0.0, 0.0), (1.0, 1.0)],
                       "alpha": [(0.0, 1.0), (0.375, 0.5), (1.0, 1.0)]})
    cm.move_point("alpha", 0, 0.3, 0.25)
    cm.move_point("alpha", 1, 2.0, 0.5)
    with pytest.raises(ValueError):
        cm.remove_point("alpha", 0)
    i = cm.add_point("alpha", 0.25, 0.875)
    cm.add_point("green", 0.5, 0.75)
    cm.remove_point("alpha", i)
    d = mod.ColorMap.default()
    paths = [str(tmp_path / f"{tag}.lba"), str(tmp_path / f"{tag}.lbb")]
    d.save_lba(paths[0])
    d.save_lbb(paths[1])
    fit = mod.ColorMap.from_table(tf_j.default_color_map(256), n_points=64)
    return cm, d, paths, fit


def test_colormap_matches_jax(tmp_path):
    cm_a, d_a, paths_t, fit_t = _colormap_run(cm_t, tmp_path, "t")
    cm_b, d_b, paths_j, fit_j = _colormap_run(cm_j, tmp_path, "j")
    assert cm_a.points == cm_b.points and d_a.points == d_b.points
    assert fit_t.points == fit_j.points
    for size in (5, 256):
        np.testing.assert_allclose(cm_a.sample(size), cm_b.sample(size), atol=1e-6)
        np.testing.assert_allclose(d_a.sample(size), d_b.sample(size), atol=1e-6)
    for pt, pj in zip(paths_t, paths_j):
        with open(pt, "rb") as f, open(pj, "rb") as g:
            assert f.read() == g.read()  # the same file format
        np.testing.assert_allclose(cm_t.load(pj), cm_j.load(pt), atol=1e-6)
    assert cm_t.ColorMap.load_lba(paths_j[0]) == d_a
    assert cm_t.ColorMap.load_lbb(paths_j[1]) == d_a
    p = str(tmp_path / "t.1dt")
    tf_j.save_1dt(p, tf_j.default_color_map(64))
    np.testing.assert_allclose(cm_t.load(p), cm_j.load(p), atol=1e-6)
    assert cm_t.load(p).shape == (64, 4)
    with pytest.raises(ValueError, match="unknown"):
        cm_t.load(str(tmp_path / "t.png"))


# ---------------------------------------------------------------- batch
def test_batch_partitioning(tmp_path):
    out = str(tmp_path)
    for i in (0, 1, 5):
        (tmp_path / f"frame_{i:06d}.png").write_bytes(b"x")
    assert batch_t.missing_frame_ranges(out, "frame_", 0, 8) == [(2, 5), (6, 8)]
    assert batch_t.missing_frame_ranges(out, "frame_", 0, 8) == batch_j.missing_frame_ranges(
        out, "frame_", 0, 8)
    for args in ((0, 10, 4), (0, 9, 4), (3, 100, 50), (7, 8, 1)):
        assert batch_t.split_range(*args) == batch_j.split_range(*args)
    assert batch_t.split_range(0, 10, 4) == [(0, 4), (4, 8), (8, 10)]
    config = json.loads(json.dumps(batch_t.DEFAULT_CONFIG))
    config["render"]["volume"] = URI
    assert batch_t.render_args(config, 3, 9) == batch_j.render_args(config, 3, 9)
    script_t = batch_t.build_sbatch_script(config, 3, 9)
    script_j = batch_j.build_sbatch_script(config, 3, 9)
    assert "-m libre_tpu_torch.apps.render_cli" in script_t
    assert script_t == script_j.replace("libre_tpu.apps", "libre_tpu_torch.apps")


def test_batch_watchdog_kills_idle_job(tmp_path):
    with pytest.raises(subprocess.CalledProcessError):
        batch_t._run_with_watchdog(["sleep", "30"], str(tmp_path), idle_timeout_s=1.0)


def test_batch_dry_run_and_example_config(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert batch_t.main(["--example-config"]) == 0
    with open(tmp_path / "example.json") as f:
        assert json.load(f) == batch_t.DEFAULT_CONFIG
    out_dir = tmp_path / "frames"
    config = {"render": {"volume": URI, "start_frame": 0, "end_frame": 7, "max_frames": 3},
              "slurm": {"output_dir": str(out_dir)}}
    (tmp_path / "c.json").write_text(json.dumps(config))
    capsys.readouterr()
    assert batch_t.main(["-c", "c.json", "--dry-run", "-v"]) == 0
    text = capsys.readouterr().out
    assert "Create 3 job(s)" in text and "3 job(s) planned" in text
    assert text.count("-m libre_tpu_torch.apps.render_cli") == 3
    assert "--frames 6 7" in text
    config["render"]["volume"] = ""
    (tmp_path / "c.json").write_text(json.dumps(config))
    assert batch_t.main(["-c", "c.json", "--dry-run"]) == 2
    assert batch_t.main([]) == 2


def test_batch_local_job_runs_port_render_cli(tmp_path, monkeypatch):
    """A local job runs ``python -m libre_tpu_torch.apps.render_cli`` with
    the job's frame range; its command line is the JAX batch's with the
    port's module."""
    calls = []
    monkeypatch.setattr(batch_t.subprocess, "run",
                        lambda cmd, check: calls.append(cmd))
    config = json.loads(json.dumps(batch_t.DEFAULT_CONFIG))
    config["render"].update(volume=URI, start_frame=0, end_frame=4, max_frames=2,
                            idle_timeout_min=0)
    config["slurm"]["output_dir"] = str(tmp_path)
    assert batch_t.submit_jobs(config, "local", dry_run=False, verbose=False) == 0
    assert [c[:3] for c in calls] == [[sys.executable, "-m",
                                       "libre_tpu_torch.apps.render_cli"]] * 2
    assert calls[1][3:] == batch_j.render_args(config, 2, 4)


# -------------------------------------------------------------- convert
def test_convert_matches_jax(tmp_path, capsys):
    src = "mem://#40,32,24,8?pattern=gradient&datatype=uint16"
    paths = [str(tmp_path / "t.lod"), str(tmp_path / "j.lod")]
    argv = ["--volume", src, "--block-size", "16", "--overlap", "2"]
    assert convert_t.main(argv + ["--output", paths[0]]) == 0
    assert convert_j.main(argv + ["--output", paths[1]]) == 0
    assert "wrote" in capsys.readouterr().out
    ds_t, ds_j = DataSourceT(f"lod://{paths[0]}"), DataSourceJ(f"lod://{paths[1]}")
    info_t, info_j = ds_t.volume_info, ds_j.volume_info
    assert info_t.voxels == info_j.voxels == (40, 32, 24)
    assert info_t.root_node.depth == info_j.root_node.depth
    assert info_t.data_type.value == info_j.data_type.value == "uint16"
    ids = sorted(ds_t._plugin._toc)
    assert ids == sorted(ds_j._plugin._toc) and len(ids) > 1
    from libre_tpu.core.nodeid import NodeId as NodeIdJ
    from libre_tpu_torch.core.nodeid import NodeId as NodeIdT

    for i in ids:
        np.testing.assert_array_equal(ds_t.get_data(NodeIdT(i)), ds_j.get_data(NodeIdJ(i)))
    # The source's full-resolution bricks come back from the finest level.
    src_t = DataSourceT(src)
    finest = [i for i in ids if NodeIdT(i).level == info_t.root_node.depth - 1]
    assert finest and ds_t.get_data(NodeIdT(finest[0])).dtype == np.uint16
    assert src_t.volume_info.voxels == info_t.voxels


# --------------------------------------------------------------- serve
def services(width=24, height=24, uri=URI, sse=1.0):
    svc_t = ServiceT(uri, width=width, height=height, port=0, device="cpu")
    svc_j = ServiceJ(uri, width=width, height=height, port=0, mesh=None)
    for s in (svc_t, svc_j):
        s.server.params["sse"] = sse
    return svc_t, svc_j


def assert_frame_close(got, want):
    d = np.abs(got - want)
    assert float(d.max()) <= FRAME_MAX and float(d.mean()) <= FRAME_MEAN, (d.max(), d.mean())


@pytest.mark.parametrize("renderer", ["bricked", "exact"])
def test_render_service_matches_jax(renderer):
    """Frames of both services on the same steering state: within 5e-5
    max and 1e-5 mean, the histogram JSON exactly equal; a colormap edit
    re-renders the bricked frame from the cached store."""
    svc_t, svc_j = services()
    assert svc_t.renderer == "bricked" and svc_t.engine.device.type == "cpu"
    for s in (svc_t, svc_j):
        s.server.params["synchronous"] = True
        s.server.params["renderer"] = renderer
    got, want = svc_t.render_frame(), svc_j.render_frame()
    assert got.shape == (24, 24, 4) and float(got[..., 3].max()) > 0.01
    assert_frame_close(got, want)
    assert svc_t._histogram == svc_j._histogram
    assert sum(svc_t._histogram["bins"]) > 8 ** 3
    if renderer == "bricked":
        assert len(svc_t.engine._store_cache) == 1
        key = next(iter(svc_t.engine._store_cache))
        for s in (svc_t, svc_j):
            cm = np.asarray(s.frame_data.render_settings.color_map)
            s.frame_data.render_settings.color_map = np.roll(cm, 32, axis=0)
        got2, want2 = svc_t.render_frame(), svc_j.render_frame()
        assert next(iter(svc_t.engine._store_cache)) == key
        assert np.abs(got2 - got).max() > 1e-3
        assert_frame_close(got2, want2)


def test_render_service_frame_is_the_engine_frame():
    """A served frame is the engine's own frame at the service's camera,
    bit for bit, and its histogram the engine's."""
    svc_t, _svc_j = services()
    svc_t.server.params["synchronous"] = True
    canvas = svc_t.render_frame()
    camera, frustum = svc_t.view_camera(24, 24, 0.0)
    img, stats = svc_t.engine.render_bricked(camera, frustum, collect_histogram=True,
                                             **svc_t.frame_keywords())
    np.testing.assert_array_equal(canvas, img.numpy())
    assert svc_t._histogram["bins"] == stats.histogram.bins.tolist()


def test_render_service_async_converges_to_sync():
    """The async steering default converges to the synchronous image."""
    svc_t, svc_j = services()
    svc_t.server.params["synchronous"] = True
    img_sync = svc_t.render_frame()
    async_svc = ServiceT(URI, width=24, height=24, port=0, device="cpu")
    async_svc.server.params["sse"] = 1.0
    assert async_svc.server.params["synchronous"] is False
    img_async = async_svc.render_frame()  # converges internally
    np.testing.assert_array_equal(img_async, img_sync)
    assert async_svc._histogram == svc_t._histogram
    svc_j.server.params["synchronous"] = False
    assert_frame_close(img_async, svc_j.render_frame())


def test_render_service_progressive_redraw():
    """progressive=True renders what is resident and re-arms the redraw
    when the uploads it started land."""
    svc = ServiceT(URI, width=24, height=24, port=0, device="cpu")
    svc.server.params["sse"] = 1.0
    svc._dirty.clear()
    first = svc.render_frame(progressive=True)  # nothing resident yet
    assert float(np.abs(first).max()) == 0.0
    assert svc._dirty.wait(timeout=60), "redraw never fired"
    img = svc.render_frame(progressive=True)
    assert img[..., 3].max() > 0.01


@pytest.mark.parametrize("layout", ["1x2", "2x2"])
def test_multi_view_layouts(layout):
    """Each view of a layout is the JAX engine's frame at that view's
    camera (the port renders views one after another); the canvas is
    also held against the JAX service's, which renders a 2×2 through its
    wall.  The layout switches over HTTP."""
    svc_t, svc_j = services(width=32, height=32)
    for s in (svc_t, svc_j):
        s.server.params["synchronous"] = True
    svc_t.server.start()
    try:
        base = _base(svc_t.server)
        assert _req(f"{base}/layout", "PUT", {"name": layout}) == {
            "layout": layout, "layouts": ["single", "1x2", "2x2"]}
        svc_j.layout = layout
        canvas = svc_t.render_frame()
        eng_j = EngineJ(DataSourceJ(URI), filter_mode="trilinear")
        views = svc_t._layout_views()
        assert len(views) == (2 if layout == "1x2" else 4)
        for dx, dy, vw, vh, az in views:
            cam_t, fr_t = svc_t.view_camera(vw, vh, az)
            cam_j = CameraJ(inv_proj=cam_t.inv_proj, inv_mv=cam_t.inv_mv,
                            viewport=cam_t.viewport, near=cam_t.near)
            want, _ = eng_j.render_bricked(cam_j, FrustumJ(fr_t.mv, fr_t.proj),
                                           **svc_t.frame_keywords())
            assert_frame_close(canvas[dy : dy + vh, dx : dx + vw], np.asarray(want))
        assert_frame_close(canvas, svc_j.render_frame())
        assert svc_t._histogram == svc_j._histogram
        quads = [canvas[dy : dy + vh, dx : dx + vw] for dx, dy, vw, vh, _ in views]
        assert np.abs(quads[0] - quads[1]).max() > 1e-3
        assert _req(f"{base}/layout", "PUT", {"cycle": 1})["layout"] == (
            "2x2" if layout == "1x2" else "single")
        assert _req(f"{base}/layout", "PUT", {"name": "3x3"}) == {"error": "unknown layout 3x3"}
    finally:
        svc_t.server.stop()


def test_render_service_endpoints_match_jax():
    """Both services over HTTP after the same requests: the same JSON
    from /histogram, /params, /camera, /colormap and /layout; /statistics
    with the same keys and types (the cache counts are the copied
    core/cache.py's, not held to the JAX engine's); a JPEG from
    /image-jpeg; /exit stops the run loop."""
    svc_t, svc_j = services()
    answers, stats = [], []
    for s in (svc_t, svc_j):
        s.server.start()
        base = _base(s.server)
        try:
            _req(f"{base}/params", "PUT", {"synchronous": True})
            _req(f"{base}/camera", "PUT", {"position": [0.3, 0.2, 1.4]})
            _req(f"{base}/camera", "PUT", {"lookat": [0, 0, 0]})
            jpeg = _req(f"{base}/image-jpeg", "POST", {})
            assert jpeg[:2] == b"\xff\xd8"
            answers.append([_req(base + p) for p in
                            ("/histogram", "/params", "/camera", "/colormap", "/layout")])
            stats.append(_req(f"{base}/statistics"))
            assert _req(f"{base}/exit", "POST", {}) == {"ok": True}
            for _ in range(100):  # /exit stops the service after it answers
                if not s._running:
                    break
                time.sleep(0.05)
            assert not s._running
        finally:
            s.server.stop()
    assert answers[0] == answers[1]
    assert sum(answers[0][0]["bins"]) > 0

    def shape(obj):
        if isinstance(obj, dict):
            return {k: shape(v) for k, v in obj.items()}
        return type(obj).__name__

    assert shape(stats[0]) == shape(stats[1])
    assert stats[0]["data_cache"]["objects"] > 0


def test_render_service_run_loop_and_client(tmp_path, capsys):
    """The run loop renders on demand while the steering client drives
    it over HTTP; ``exit`` ends the loop."""
    import threading

    svc = ServiceT(URI, width=16, height=16, port=0, device="cpu")
    svc.server.params["synchronous"] = True
    done = []
    loop = threading.Thread(target=lambda: done.append(svc.run(max_frames=50)), daemon=True)
    loop.start()
    try:
        for _ in range(100):
            if svc.server._thread is not None:
                break
            loop.join(0.05)
        base = _base(svc.server)
        client = ["--url", base]
        assert steering_client.main(client + ["camera", "--position", "0.2", "0.1", "1.4",
                                              "--lookat", "0", "0", "0"]) == 0
        assert steering_client.main(client + ["params", "--sse", "1.0"]) == 0
        assert steering_client.main(client + ["colormap", "--preset", "grayscale",
                                              "--point", "alpha", "0.5", "0.9",
                                              "--save", str(tmp_path / "g.lba")]) == 0
        assert steering_client.main(client + ["grab", "--output", str(tmp_path / "f.jpg")]) == 0
        assert (tmp_path / "f.jpg").read_bytes()[:2] == b"\xff\xd8"
        assert steering_client.main(client + ["histogram"]) == 0
        assert steering_client.main(client + ["layout", "--name", "1x2"]) == 0
        assert steering_client.main(client + ["stats"]) == 0
        text = capsys.readouterr().out
        assert '"bins"' in text and '"layout": "1x2"' in text and '"data_cache"' in text
        # The table pushed: the JAX client's edit of the same preset.
        cmap = cm_j.ColorMap.from_table(tf_j.grayscale_ramp())
        cmap.add_point("alpha", 0.5, 0.9)
        np.testing.assert_allclose(svc.frame_data.render_settings.color_map, cmap.sample(),
                                   atol=1e-6)
        assert cm_t.ColorMap.load_lba(str(tmp_path / "g.lba")) == cm_t.ColorMap.from_table(
            cmap.sample())
        assert steering_client.main(client + ["exit"]) == 0
        loop.join(60)
        assert not loop.is_alive() and done and done[0] >= 1
    finally:
        svc.stop()
        svc.server.stop()


def test_render_service_sharded_matches_jax_mesh():
    """``RenderService(mesh=Mesh)`` serves sharded bricked frames: the
    frame is the engine's sharded frame at the service's camera, bit for
    bit, within 5e-5 / 1e-5 of the JAX service on a 2 × 4 mesh of its CPU
    devices, and ``mesh="auto"`` on the CPU means no mesh."""
    from libre_tpu.parallel import make_mesh as make_mesh_j
    from libre_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_brick=2, n_ray=4, devices=["cpu"] * 8)
    svc_t = ServiceT(URI, width=24, height=24, port=0, device="cpu", mesh=mesh)
    svc_j = ServiceJ(URI, width=24, height=24, port=0, mesh=make_mesh_j(n_brick=2, n_ray=4))
    for s in (svc_t, svc_j):
        s.server.params["sse"] = 1.0
        s.server.params["synchronous"] = True
    got, want = svc_t.render_frame(), svc_j.render_frame()
    assert svc_t.engine.sharded_frames == 1 and float(got[..., 3].max()) > 0.01
    assert_frame_close(got, want)
    camera, frustum = svc_t.view_camera(24, 24, 0.0)
    img, _ = svc_t.engine.render_bricked(camera, frustum, **svc_t.frame_keywords())
    np.testing.assert_array_equal(got, img.numpy())
    assert svc_t.engine.sharded_frames == 2
    assert ServiceT(URI, width=8, height=8, port=0, device="cpu").engine.mesh is None


def test_render_cli_mesh(tmp_path, capsys):
    """``render_cli --mesh 2x2`` on CPU shards writes the sharded frame,
    equal (5e-5) to the one-device CLI frame; ``--mesh-devices`` names the
    shards' devices."""
    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.utils.image import read_image

    frames = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2x2"]),
                        ("listed", ["--mesh", "1x2", "--mesh-devices", "cpu,cpu"])):
        out = tmp_path / name
        rc = render_cli.main(["--volume", URI, "--width", "24", "--height", "24",
                              "--sse", "1", "--device", "cpu", "-o", str(out)] + extra)
        assert rc == 0
        frames[name] = read_image(str(out / "frame_000000.png")).astype(np.float32)
    text = capsys.readouterr().out
    assert "mesh: {'ray': 2, 'brick': 2}" in text and "mesh: {'ray': 1, 'brick': 2}" in text
    for name in ("mesh", "listed"):
        assert np.abs(frames[name] - frames["one"]).max() <= 1.0  # 8-bit PNG: one step
