"""The port imports no jax: every libre_tpu_torch module imports, and a
tiny CPU frame renders, in a process where importing jax fails."""

import os
import subprocess
import sys

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
import libre_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    libre_tpu_torch.__path__, "libre_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from libre_tpu.core.frustum import Frustum, look_at, perspective
from libre_tpu.data.datasource import DataSource, load_plugins
from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.render.engine import RenderEngine
load_plugins()
camera, frustum = build_camera(16, 16, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))
engine = RenderEngine(DataSource("mem://#32,32,32,16?pattern=gradient"),
                      max_gpu_cache_mb=16, device="cpu")
img, _ = engine.render_bricked(camera, frustum, n_planes=16)
assert img.shape == (16, 16, 4) and float(img[..., 3].max()) > 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
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
