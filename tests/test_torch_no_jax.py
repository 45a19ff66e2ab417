"""The port imports neither jax nor anything of the JAX package: every
libre_tpu_torch module imports, a tiny CPU frame renders through the
bricked path and through the exact path, and the store trainer and the
exact trainer each take a step, in a process where importing jax, optax
or libre_tpu fails."""

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
