"""A cell, configuration, traffic mix, driver and per-layer metric added as
files (and entries) only, in a copy of the benchmark: the harness finds
each by name and edits nothing."""

import json

from conftest import make_tiny_root, run_cpu

DRIVER = '''
import torch


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.n, self.log = config["n"] * traffic["scale"], []

    def setup(self):
        self.x = torch.ones(self.n)

    def unit(self):
        self.x = self.x * 1.0
        self.log.append(0)
        return True

    def release(self):
        pass

    def check(self):
        return {"dummy_gap": float((self.x - 1.0).abs().max())}

    def end_to_end(self, units, window_s):
        return {"dummy_rate": units / window_s}

    def launch_bounds(self, kernel):
        return None
'''

METRIC = '''
def read(trace, driver):
    return float(len(driver.log))
'''


def test_added_files_are_found(tmp_path):
    root = make_tiny_root(tmp_path / "checkout")
    bench_dir = root / "perfbench"
    (bench_dir / "configs" / "dummy.json").write_text(json.dumps({"n": 4, "reduced": []}))
    (bench_dir / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"driver": "dummy_driver", "scale": 2}))
    (bench_dir / "limits" / "dummy.cell.json").write_text(
        json.dumps({"limits": {"dummy_gap": 0.0}}))
    # drivers/ and metrics/ are links into the real tree; a later PR adds
    # its files beside the others, here into copies.
    for sub in ("drivers", "metrics"):
        link = bench_dir / sub
        target = link.resolve()
        link.unlink()
        link.mkdir()
        for f in target.glob("*.py"):
            (link / f.name).write_text(f.read_text())
    (bench_dir / "drivers" / "dummy_driver.py").write_text(DRIVER)
    (bench_dir / "metrics" / "dummy_units.py").write_text(METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                             "file": "perfbench/configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy_mix",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].insert(0, {"name": "dummy_rate", "unit": "1/s", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["dummy.cell"]})
    bench["per_layer"].append({"name": "dummy_units", "unit": "1", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "dummy_rate", "workloads": ["dummy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = run_cpu(root, "dummy.cell", seconds=0.2)
    assert plain["correct"] is True and plain["failed"] == 0
    assert set(plain["metrics"]) == {"dummy_rate", "setup_s"}
    assert plain["compared"] == {"dummy_gap": {"value": 0.0, "limit": 0.0}}
    traced = run_cpu(root, "dummy.cell", seconds=0.2, trace=1)
    assert traced["metrics"] == {"dummy_units": {"value": float(traced["attempted"]),
                                                 "unit": "1"}}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert list(traced)[-1] == "compared"
