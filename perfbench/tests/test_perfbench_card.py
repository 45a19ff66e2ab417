"""On the card only (skips without one): each cell runs end to end at its
own size for a short window and comes out correct; its traced run reads
every per-layer metric the cell lists."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(cell, trace):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "2", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_traced(card, cell):
    result = run(cell, 0)
    assert result["correct"] is True, result["compared"]
    assert result["device"]["platform"] == "gpu"
    traced = run(cell, 1)
    listed = {m["name"] for m in BENCH["per_layer"] if cell in m["workloads"]}
    assert set(traced["metrics"]) == listed
    assert 0.0 < traced["device"]["busy_s"] <= traced["device"]["window_s"]
