"""What the benchmark loads: a run leaves no ``jax``, ``jaxlib``, ``flax``
or ``libre_tpu`` among the top-level modules (``libre_tpu_torch`` is
another name); the references import nothing of the program; without a
card the command exits non-zero and prints no result."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

RUN_TINY = """
import sys, time, json
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import make_tiny_root
from pathlib import Path
from perfbench import harness
root = make_tiny_root(Path({tmp!r}))
harness.run(["--workload", {cell!r}, "--seed", "2147483650", "--seconds", "0.3",
             "--trace", "0"], root, time.perf_counter(), device_check=lambda c: "cpu")
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""


@pytest.mark.parametrize("cell", ["fit.store512", "view.exact512"])
def test_a_run_loads_no_jax(tmp_path, cell):
    code = RUN_TINY.format(root=str(ROOT), tests=str(ROOT / "perfbench" / "tests"),
                           tmp=str(tmp_path / "checkout"), cell=cell)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "libre_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "libre_tpu"}


def test_forbidden_names_compare_whole():
    from perfbench import harness

    assert harness.forbidden_modules(["libre_tpu_torch", "libre_tpu_torch.ops", "jaxtyping",
                                      "flaxen", "perfbench"]) == []
    assert harness.forbidden_modules(["libre_tpu.ops", "jax.numpy", "jaxlib"]) == [
        "jax", "jaxlib", "libre_tpu"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "typing", "numpy", "torch", "perfbench"}, tops
    assert not any(n.startswith("perfbench.") and not n.startswith("perfbench.reference")
                   for n in _imports(path))


def test_without_a_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fit.store512",
                          "--seed", "2147483651", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_outside_a_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and perfbench/: the program
    is missing, so the run fails before any result."""
    import shutil

    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "fit.store512",
                          "--seed", "2147483652", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
