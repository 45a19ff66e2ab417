"""The port's ``utils/profiling`` against the JAX package's: the same
``StageTimers.report()`` text for the same totals, ``device_trace`` on
the CPU writing a Chrome trace (and doing nothing for None), nested
``span`` ranges in that trace, ``span`` as the shared no-op context while
no profiler records, and the program's ``libre.*`` spans, nested as
named, on every trainer's step (the store trainer's on one device and
over slabs, the exact trainer's, the mesh trainer's and the dense
trainer's, with its classification and TF gathers) and a ``VolumeScene``
frame of one and of two samples a pixel."""

import json
import os

import numpy as np
import pytest
import torch

from libre_tpu.utils import profiling as prof_j
from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.utils import profiling as prof_t

TOTALS = {"select": (0.0123456, 3), "upload": (1.5, 2), "render": (0.25, 7), "a": (1e-6, 1)}


def _filled(module):
    timers = module.StageTimers()
    for name, (seconds, count) in TOTALS.items():
        timers.totals[name] = seconds
        timers.counts[name] = count
    return timers


def test_stage_timers_report_matches_jax():
    got, want = _filled(prof_t).report(), _filled(prof_j).report()
    assert got == want
    assert got.splitlines()[0] == "a: 0.00 ms total / 1 = 0.00 ms avg"
    timers = prof_t.StageTimers()
    for _ in range(2):
        with timers.stage("x"):
            pass
    assert timers.counts["x"] == 2 and timers.totals["x"] >= 0.0
    with pytest.raises(RuntimeError):
        with timers.stage("raises"):
            raise RuntimeError("the stage is timed all the same")
    assert timers.counts["raises"] == 1
    timers.reset()
    assert timers.report() == ""


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with prof_t.device_trace(None) as nothing:
        assert nothing is None
    log_dir = str(tmp_path / "trace")
    with prof_t.device_trace(log_dir) as prof:
        with prof_t.span("outer"):
            with prof_t.span("inner"):
                torch.ones(64).cumsum(0)
    path = os.path.join(log_dir, prof_t.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "inner"} <= names


def test_span_is_the_shared_noop_without_a_profiler(tmp_path):
    first, second = prof_t.span("libre.a"), prof_t.span("libre.b")
    assert first is prof_t.NO_SPAN and second is prof_t.NO_SPAN
    with first:
        with second:
            torch.ones(8).sum()
    with prof_t.device_trace(str(tmp_path)) as prof:
        with prof_t.span("libre.inside") as inside:
            torch.ones(8).sum()
    assert inside is not prof_t.NO_SPAN
    names = {e.key for e in prof.key_averages()}
    assert "libre.inside" in names and not {"libre.a", "libre.b"} & names
    assert prof_t.span("libre.after") is prof_t.NO_SPAN


def _store_problem():
    import numpy as np

    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.train.store_trainer import StoreProblem

    vs = swg.view_vector(world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2,
                         eye=[0.1, 0.05, 1.4], sign=-1.0,
                         slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(6, 5),
                         max_samples_per_ray=32)
    return StoreProblem(views=vs[None], na_store=8, na_real=8, nc_real=8, nb_real=8,
                        k_planes=8, inter_size=(6, 5), world_min=np.float32([-0.5] * 3),
                        world_max=np.float32([0.5] * 3), axis=2)


def _store_step(first=False):
    """A store train step; with ``first``, each run the first step of a new
    loss function, which builds its views' sweep tables."""
    from libre_tpu_torch.train.store_trainer import make_train_step

    problem = _store_problem()
    params = {"store": torch.full((8, 8, 8), 0.5).requires_grad_(),
              "tf": torch.linspace(0, 1, 1024).reshape(256, 4).requires_grad_()}
    opt = torch.optim.Adam([params["store"], params["tf"]], lr=1e-2)
    step = make_train_step(problem, opt)
    targets = torch.zeros((1, 6, 5, 4))
    if first:
        return lambda: make_train_step(problem, opt)(params, targets)
    return lambda: step(params, targets)


def _slab_step():
    """A store train step over a store in two slabs, on a 1×2 CPU mesh."""
    from libre_tpu_torch.parallel.mesh import make_mesh
    from libre_tpu_torch.train.store_trainer import (
        make_slab_train_step,
        shard_store_slabs_uniform,
    )

    slabs = [s.requires_grad_() for s in shard_store_slabs_uniform(torch.full((8, 8, 8), 0.5), 2)]
    params = {"slabs": slabs, "tf": torch.linspace(0, 1, 1024).reshape(256, 4).requires_grad_()}
    opt = torch.optim.Adam([*slabs, params["tf"]], lr=1e-2)
    mesh = make_mesh(n_brick=2, n_ray=1, devices=["cpu", "cpu"])
    step = make_slab_train_step(_store_problem(), opt, mesh)
    return lambda: step(params, torch.zeros((1, 6, 5, 4)))


def _dense_step():
    """A dense (plain shear-warp, pre-classified) train step: a
    classification a view with its TF gathers, their backward."""
    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.train.shearwarp_trainer import ShearWarpProblem, make_train_step

    camera = build_camera(12, 10, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))[0]
    problem = ShearWarpProblem.from_cameras(
        [camera], [-0.5] * 3, [0.5] * 3,
        RenderParams(data_source_range=(0.0, 1.0), filter_mode="trilinear"),
        sw.ShearWarpParams(n_planes=8, inter_size=(6, 5)))
    params = {"volume": torch.full((8, 8, 8), 0.5).requires_grad_(),
              "tf": torch.linspace(0, 1, 1024).reshape(256, 4).requires_grad_()}
    step = make_train_step(problem, torch.optim.Adam([params["volume"], params["tf"]], lr=1e-2))
    return lambda: step(params, [torch.zeros((6, 5, 4))])


def _exact_parts(samples_per_pixel=1):
    import numpy as np

    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.ops.reference import RenderParams

    camera, _frustum = build_camera(12, 10, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))
    params = RenderParams(n_samples_per_ray=16, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear", early_exit=1.1,
                          samples_per_pixel=samples_per_pixel)
    tf = np.stack([np.linspace(0, 1, 256, dtype=np.float32)] * 4, axis=-1)
    return camera, params, tf


def _exact_step():
    import numpy as np

    from libre_tpu_torch.ops.exact import exact_view
    from libre_tpu_torch.train import init_exact_state, make_exact_train_step

    camera, params, tf = _exact_parts()
    state = init_exact_state(np.full((8, 8, 8), 0.5, np.float32), tf,
                             lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
    view = exact_view(camera, params, device="cpu")
    step = make_exact_train_step(view)
    return lambda: step(state, torch.zeros(view.n_rays, 4))


def _scene_frame(samples_per_pixel=1):
    import numpy as np

    from libre_tpu_torch.models import VolumeScene

    camera, params, tf = _exact_parts(samples_per_pixel)
    scene = VolumeScene.from_volume(np.full((8, 8, 8), 0.7, np.float32), tf, device="cpu",
                                    params=params)
    return lambda: scene.render(camera)


def _set_step():
    from libre_tpu_torch.parallel.mesh import make_mesh
    from libre_tpu_torch.parallel.render import shard_bricks_front_to_back
    from libre_tpu_torch.testing import split_into_bricks
    from libre_tpu_torch.train import InverseRenderProblem, init_state, make_train_step

    camera, params, tf = _exact_parts()
    bricks, _ = shard_bricks_front_to_back(
        split_into_bricks(np.full((8, 8, 8), 0.5, np.float32), 2, 1, device="cpu"),
        np.float32([0.2, 0.1, 1.4]), 1)
    problem = InverseRenderProblem(bricks, (-0.5,) * 3, (0.5,) * 3, params, 16, width=12)
    mesh = make_mesh(devices=["cpu"])
    adam = lambda p: torch.optim.Adam(p, lr=1e-2)  # noqa: E731
    state = init_state(problem, tf, adam, mesh=mesh)
    step = make_train_step(problem, adam, mesh)
    eye, dirs, cos_z, _ = ray_ops.make_rays(camera.inv_proj, camera.inv_mv, camera.viewport,
                                            device="cpu")
    rays = (eye, dirs.reshape(-1, 3), ray_ops.near_plane_t(cos_z.reshape(-1), camera.near))
    return lambda: step(state, *rays, torch.zeros(120, 4))


# (path, its set-up, each span named with the span it nests in; None: the outermost)
STEP = {"libre.train.step": None, "libre.train.loss": "libre.train.step",
        "libre.train.backward": "libre.train.step", "libre.train.update": "libre.train.step"}
# On the CPU the plain K1 classifies each plane through ``lookup``, whose
# TF gathers open their span inside the sweep's.
STORE = {**STEP, "libre.sweep.forward": "libre.train.loss",
         "libre.sweep.backward": "libre.train.backward",
         "libre.tf.take_rows": "libre.sweep.forward"}
DENSE = {**STEP, "libre.dense.forward": "libre.train.loss",
         "libre.dense.classify": "libre.dense.forward",
         "libre.tf.take_rows": "libre.dense.classify",
         "libre.tf.take_rows.backward": "libre.train.backward"}
PATHS = {
    # A later step reuses the tables its loss function built on its first.
    "store_step": (_store_step, STORE),
    "store_first_step": (lambda: _store_step(first=True),
                         {**STORE, "libre.sweep.tables": "libre.train.loss"}),
    "slab_step": (_slab_step, STORE),
    "dense_step": (_dense_step, DENSE),
    "exact_step": (_exact_step, {
        "libre.train.step": None, "libre.train.loss": "libre.train.step",
        "libre.exact.forward": "libre.train.loss", "libre.train.backward": "libre.train.step",
        "libre.exact.backward": "libre.train.backward",
        "libre.train.update": "libre.train.step"}),
    "set_step": (_set_step, {
        "libre.train.step": None, "libre.train.loss": "libre.train.step",
        "libre.shard.rays": "libre.train.loss", "libre.exact.forward": "libre.train.loss",
        "libre.shard.composite": "libre.train.loss", "libre.train.backward": "libre.train.step",
        "libre.exact.backward": "libre.train.backward",
        "libre.train.update": "libre.train.step"}),
}
SCENE = {"libre.scene.render": None, "libre.exact.view": "libre.scene.render",
         "libre.exact.forward": "libre.scene.render"}
PATHS["scene_frame"] = (_scene_frame, SCENE)
PATHS["scene_frame_two_samples"] = (lambda: _scene_frame(samples_per_pixel=2), SCENE)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_program_spans_nest_as_named(tmp_path, path):
    make, parents = PATHS[path]
    run = make()
    run()  # outside the trace: records nothing, builds what the first call builds
    with prof_t.device_trace(str(tmp_path)) as prof:
        run()
    with open(os.path.join(str(tmp_path), prof_t.TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("libre.")]
    assert {e["name"] for e in events} == set(parents)
    samples = 2 if path.endswith("two_samples") else 1
    assert sum(e["name"] == "libre.exact.view" for e in events) == (
        samples if "libre.exact.view" in parents else 0)
    for e in events:
        parent = parents[e["name"]]
        if parent is None:
            assert sum(o["name"] == e["name"] for o in events) == 1
            continue
        assert any(o["name"] == parent and o["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= o["ts"] + o["dur"] for o in events), e["name"]
