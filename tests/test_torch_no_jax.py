"""The port imports neither jax nor anything of the JAX package (the
package-level exports and ``available_renderers``, an exact frame from
an 8192-entry TF, the
wall, the bf16 resample's plan arguments, ``demo_wall`` and
``data.memory_unit`` among the rest): every
libre_tpu_torch module imports (the later modules by name: the dense
shear-warp trainer, the volume scene, profiling, the entry point, the
four benchmark scripts), a tiny CPU frame renders through the
bricked path, the exact path and the dense shear-warp path (both
backends), the store trainer, the exact trainer and the dense shear-warp
trainer each take a step, the volume scene renders and differentiates
with its early exit on, the plane oracle and ``entry()`` run, a
gather probe runs its plain version, the render service answers a
frame and its histogram over HTTP on 127.0.0.1, and the multi-device
layer (``parallel``: mesh, compositing, bricked_sharded, render,
shearwarp_sharded, distributed, two_process; the two new benchmark
scripts) imports and ``dryrun_multichip`` runs on four CPU shards with
the mesh-sharded exact trainer's step (``train.trainer``'s
``InverseRenderProblem``, ``init_state``, ``make_train_step``, K4 over a
brick set by its plain version), and a scene of 8 bricks differentiates,
in a process where importing jax, optax or libre_tpu fails."""

import os
import subprocess
import sys

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["optax"] = None
sys.modules["libre_tpu"] = None
import torch
torch.set_num_threads(1)
import libre_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    libre_tpu_torch.__path__, "libre_tpu_torch.")]
for name in names:
    importlib.import_module(name)
later = {"libre_tpu_torch.train.shearwarp_trainer", "libre_tpu_torch.models.volume_scene",
         "libre_tpu_torch.utils.profiling", "libre_tpu_torch.entry",
         "libre_tpu_torch.benchmarks.bench_forward",
         "libre_tpu_torch.benchmarks.probe_bwd_breakdown",
         "libre_tpu_torch.benchmarks.demo_inverse_render",
         "libre_tpu_torch.benchmarks.demo_out_of_core",
         "libre_tpu_torch.parallel.mesh", "libre_tpu_torch.parallel.compositing",
         "libre_tpu_torch.parallel.bricked_sharded", "libre_tpu_torch.parallel.render",
         "libre_tpu_torch.parallel.shearwarp_sharded", "libre_tpu_torch.parallel.distributed",
         "libre_tpu_torch.parallel.two_process",
         "libre_tpu_torch.benchmarks.demo_slab_train",
         "libre_tpu_torch.benchmarks.bench_scaling",
         "libre_tpu_torch.benchmarks.demo_wall", "libre_tpu_torch.data.memory_unit"}
assert later <= set(names), later - set(names)
from libre_tpu_torch import (DataType, LODNode, NodeId, RootNode, VolumeInformation,
                             fill_regular_volume_info)
from libre_tpu_torch.render.registry import available_renderers
assert {"bricked", "pallas-exact", "shearwarp", "xla"} <= set(available_renderers())
info = fill_regular_volume_info(VolumeInformation(voxels=(32, 32, 32),
                                                  maximum_block_size=(16, 16, 16)))
assert isinstance(info.root_node, RootNode) and info.data_type is DataType.UINT8
assert LODNode(NodeId.from_coords(0, (0, 0, 0)), (16, 16, 16), (0, 0, 0), (1, 1, 1)).is_valid()
from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.data.datasource import DataSource, load_plugins
from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.render.engine import RenderEngine
load_plugins()
camera, frustum = build_camera(16, 16, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))
engine = RenderEngine(DataSource("mem://#32,32,32,16?pattern=gradient"),
                      max_gpu_cache_mb=16, device="cpu")
img, _ = engine.render_bricked(camera, frustum, n_planes=16)
assert img.shape == (16, 16, 4) and float(img[..., 3].max()) > 0
img, stats, _ = engine.render(
    camera, frustum, params=RenderParams(n_samples_per_ray=32, samples_per_pixel=2,
                                         filter_mode="trilinear"),
    screen_space_error=1.0, marcher="pallas")
assert img.shape == (16, 16, 4) and float(img[..., 3].max()) > 0
assert stats.n_passes == 1 and stats.n_available > 1
from libre_tpu_torch.testing import tf_of_size
wide = RenderEngine(DataSource("mem://#32,32,32,16?pattern=gradient"), max_gpu_cache_mb=16,
                    device="cpu")
wide.transfer_function = torch.from_numpy(tf_of_size(8192))  # past the shared instances
img, _, _ = wide.render(camera, frustum, params=RenderParams(n_samples_per_ray=32),
                        screen_space_error=1.0)
assert img.shape == (16, 16, 4) and float(img[..., 3].max()) > 0
for backend in ("jnp", "pallas"):
    img = engine.render_shearwarp(camera, n_planes=16, backend=backend)
    assert img.shape == (16, 16, 4) and float(img[..., 3].max()) > 0
wall, wall_stats = engine.render_wall([(camera, frustum, (0, 0)), (camera, frustum, (16, 0))],
                                      (16, 32), n_planes=16)
assert wall.shape == (16, 32, 4) and torch.equal(wall[:, :16], wall[:, 16:])
from libre_tpu_torch.ops.shearwarp import ShearWarpParams, make_plan
from libre_tpu_torch.ops import shearwarp_dense as swd
swp = ShearWarpParams(n_planes=16, inter_size=(8, 8), compute_dtype="bfloat16")
pa = swd.slope_grid_plan_args(make_plan(camera), [-0.5] * 3, [0.5] * 3,
                              RenderParams(n_samples_per_ray=16), swp)
assert pa.sweep_kwargs()["compute_dtype"] == "bfloat16"
import numpy as np
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.train import StoreProblem, fit
vs = swg.view_vector(world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2,
                     eye=[0.1, 0.05, 1.4], sign=-1.0,
                     slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(6, 5),
                     max_samples_per_ray=32)
problem = StoreProblem(views=vs[None], na_store=8, na_real=8, nc_real=8,
                       nb_real=8, k_planes=8, inter_size=(6, 5),
                       world_min=np.float32([-0.5] * 3),
                       world_max=np.float32([0.5] * 3), axis=2)
store = np.full((8, 8, 8), 0.5, np.float32)
tf = np.stack([np.linspace(0, 1, 256, dtype=np.float32)] * 4, axis=-1)
params, losses = fit(problem, np.zeros((1, 6, 5, 4), np.float32), store, tf,
                     device="cpu", steps=1)
assert np.isfinite(losses[0]) and float(params["store"].grad.abs().max()) > 0
from libre_tpu_torch.ops.exact import exact_view
from libre_tpu_torch.train import init_exact_state, make_exact_train_step
exact_params = RenderParams(n_samples_per_ray=16, data_source_range=(0.0, 1.0),
                            filter_mode="trilinear", early_exit=1.1)
state = init_exact_state(np.full((8, 8, 8), 0.5, np.float32), tf,
                         lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
view = exact_view(camera, exact_params, device="cpu")
loss = make_exact_train_step(view)(state, torch.zeros(view.n_rays, 4))
assert np.isfinite(float(loss)) and state.step == 1
assert float(state.params["density"].grad.abs().max()) > 0
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.train import ShearWarpProblem, fit_shearwarp
swp = sw.ShearWarpParams(n_planes=8, inter_size=(6, 6), classification="post")
problem = ShearWarpProblem.from_cameras([camera], [-0.5] * 3, [0.5] * 3,
                                        exact_params, swp)
params, losses = fit_shearwarp(problem, [np.zeros((6, 6, 4), np.float32)],
                               np.full((8, 8, 8), 0.5, np.float32), tf, device="cpu",
                               steps=1)
assert np.isfinite(losses[0]) and float(params["volume"].grad.abs().max()) > 0
plan = problem.plans[0]
ray = sw.plane_oracle(params["volume"].detach(), torch.from_numpy(tf), plan.eye,
                      plan.axis, plan.sign, (torch.zeros(1), torch.zeros(1)),
                      [-0.5] * 3, [0.5] * 3, exact_params, 8, classification="post")
assert ray.shape == (1, 4)
from libre_tpu_torch.models import VolumeScene
scene = VolumeScene.from_volume(np.full((8, 8, 8), 0.7, np.float32), device="cpu",
                                params=RenderParams(n_samples_per_ray=16,
                                                    data_source_range=(0.0, 1.0),
                                                    filter_mode="trilinear"))
leaves = {k: v.clone().requires_grad_() for k, v in scene.parameters.items()}
scene.with_parameters(leaves).render(camera).square().mean().backward()
assert float(leaves["density"].grad.abs().max()) > 0
import dataclasses
from libre_tpu_torch.testing import split_into_bricks
eight = dataclasses.replace(scene, bricks=split_into_bricks(
    np.full((8, 8, 8), 0.7, np.float32), 2, 1, device="cpu"))
leaves = {k: v.clone().requires_grad_() for k, v in eight.parameters.items()}
eight.with_parameters(leaves).render(camera).square().mean().backward()
assert leaves["density"].shape == (8, 6, 6, 6) and float(leaves["density"].grad.abs().max()) > 0
from libre_tpu_torch.entry import entry
fn, example = entry(device="cpu")
assert fn(*example).shape == (128, 128, 4)
from libre_tpu_torch.utils.profiling import StageTimers
timers = StageTimers()
with timers.stage("x"):
    pass
assert timers.report().startswith("x: ")
from libre_tpu_torch.utils.profiling import NO_SPAN, span
assert span("libre.x") is NO_SPAN
from libre_tpu_torch.benchmarks import probe_gather2
from libre_tpu_torch.ops import gather
fn, args, work = probe_gather2.build_lane_gather_loop(device="cpu")
out = gather.take_along(*args, axis=1, loop=probe_gather2.LOOP, mod=128)
assert out.shape == (8, 128) and work == 512 * 1024 and torch.equal(out, fn(*args))
import json, urllib.request
from libre_tpu_torch.apps.serve import RenderService
svc = RenderService("mem://#32,32,32,16?pattern=gradient", width=16, height=16,
                    host="127.0.0.1", port=0, max_gpu_cache_mb=16, device="cpu")
svc.server.start()
try:
    host, port = svc.server.address
    assert host == "127.0.0.1"
    base = f"http://{host}:{port}"
    with urllib.request.urlopen(urllib.request.Request(
            base + "/image-jpeg", data=b"{}", method="POST"), timeout=120) as resp:
        assert resp.read()[:2] == b"\xff\xd8"
    with urllib.request.urlopen(base + "/histogram", timeout=60) as resp:
        hist = json.loads(resp.read())
    assert sum(hist["bins"]) > 0 and hist["max"] == 255.0
finally:
    svc.server.stop()
from libre_tpu_torch.entry import dryrun_multichip
out = dryrun_multichip(4, ["cpu"] * 4, exact_trainer=True)
assert out["mesh"] == {"ray": 2, "brick": 2} and out["slab_grad_max"] > 0
assert np.isfinite(out["exact_train_loss"])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "optax", "libre_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names), "modules")
"""


def test_port_imports_and_renders_without_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p
    )
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "modules" in proc.stdout
