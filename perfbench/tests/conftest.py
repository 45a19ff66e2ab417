"""Fixtures of the benchmark's CPU tests: the card (tests that need it
skip without one), and a checkout of the benchmark whose configurations
and traffic are cut to a size the CPU renders in seconds."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny sizes: every width cut, so the plain versions the program runs on
# the CPU finish a run in seconds.
TINY_CONFIG = {
    "store512": {"volume": {"uri": "mem://#16,16,16,4?pattern=gradient"}, "viewport": [16, 16],
                 "samples_per_ray": 16, "slope_grid": [16, 16]},
    "exact512": {"volume": {"n": 16}, "renderer": {"samples_per_ray": 16}},
    "batch512": {"volume": {"n": 16}, "viewport": [24, 16], "renderer": {"samples_per_ray": 32}},
}
TINY_TRAFFIC = {
    "fit_store": {"job_steps": 4}, "fit_density": {"job_steps": 4},
    "fit_exact": {"viewport": [16, 16], "job_steps": 4, "reference_block": 100},
    "view_batch": {"reference_block": 100},
}

# At 16^3 a sound run's step_gap reads ~1.6e-4 (Adam's sign-like first
# steps turn round-off in the many near-zero gradient entries of a tiny
# store into a visible share of its change); at the cells' own size it
# reads under 2e-7.  The tiny checkout takes 1e-3 there; the control and
# the faults read 4e-3 and more at this size.
TINY_LIMITS = {"fit.store512": {"step_gap": 1e-3}, "fit_density.store512": {"step_gap": 1e-3}}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def make_tiny_root(dest: Path) -> Path:
    """A checkout of the benchmark at ``dest`` with the cells' files cut
    to tiny sizes; code directories are linked to the real ones."""
    bench = dest / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    for sub in ("drivers", "metrics", "work", "reference"):
        (bench / sub).symlink_to(ROOT / "perfbench" / sub)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, over in TINY_CONFIG.items():
        cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
        (bench / "configs" / f"{name}.json").write_text(json.dumps(_merge(cfg, over)))
    for name, over in TINY_TRAFFIC.items():
        t = json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(_merge(t, over)))
    for f in (ROOT / "perfbench" / "limits").glob("*.json"):
        limits = json.loads(f.read_text())
        limits["limits"].update(TINY_LIMITS.get(f.stem, {}))
        (bench / "limits" / f.name).write_text(json.dumps(limits))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


def run_cpu(root: Path, workload: str, seed: int = 2147483701, trace: int = 0,
            seconds: float = 0.5):
    """One run of ``workload`` under ``root`` on the CPU, past the
    harness's look for a card."""
    import time

    from perfbench import harness

    return harness.run(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], root, time.perf_counter(),
                       device_check=lambda chips: "cpu")
