"""One run of one cell: set-up, the measured window, the check against
the reference, the result line.

Everything cell-specific is found by name under ``<root>/perfbench``:
the cell in ``BENCHMARK.json``, its configuration ``configs/<config>.json``,
its traffic ``traffic/<traffic>.json``, whose ``driver`` names
``drivers/<driver>.py`` (the code that drives the program's entry for
that kind of traffic), its limits ``limits/<cell>.json``, and each
per-layer metric's reader ``metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix or a metric adds files; it edits none."""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "libre_tpu")


class RunError(Exception):
    """A run that must exit non-zero and print no result."""


def load_file(path: Path, name: str) -> ModuleType:
    """Import the module at ``path`` (a driver or metric found by name)."""
    if not path.is_file():
        raise RunError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(names=None) -> List[str]:
    """The top-level names of ``names`` (default: the loaded modules) that
    the benchmark may not load, compared whole (``libre_tpu_torch`` is
    not ``libre_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def require_device(chips: int) -> str:
    """The card's name; raises when the run has no CUDA device or fewer
    than the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA device: this benchmark measures the port on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} devices, {torch.cuda.device_count()} seen")
    return torch.cuda.get_device_name(0)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv, root: Path, started: float, device_check=require_device) -> Dict:
    """The result dict of one run (see ``perfbench/run.py``)."""
    args = parse(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise RunError(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    kind = device_check(cell["chips"])

    import torch

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    driver_mod = load_file(root / "perfbench" / "drivers" / f"{traffic['driver']}.py",
                           f"perfbench_driver_{traffic['driver']}")
    driver = driver_mod.Driver(config, traffic, args.seed, device)
    before_setup = time.perf_counter()
    driver.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    phases = [("process start to the driver (imports, the card)", before_setup - started)]
    phases += getattr(getattr(driver, "phases", None), "done", [])
    print("perfbench: set-up phases (s): "
          + "; ".join(f"{name} {sec:.3f}" for name, sec in phases), file=sys.stderr)

    from perfbench.trace import WINDOW_RANGE, Profiler

    with Profiler(bool(args.trace)) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            t0 = time.perf_counter()
            attempted = failed = 0
            while True:
                ok = driver.unit()
                attempted += 1
                failed += 0 if ok else 1
                window_s = time.perf_counter() - t0
                if window_s >= args.seconds:
                    break
    memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    driver.release()
    t_check = time.perf_counter()
    numbers = driver.check()
    check_s = time.perf_counter() - t_check
    print(f"perfbench: setup {setup_s:.3f} s, window {window_s:.3f} s over {attempted} units, "
          f"check {check_s:.3f} s", file=sys.stderr)
    jobs = getattr(driver, "jobs", None)
    if jobs is not None:
        print("perfbench: the window's whole jobs, ms a step: "
              + " ".join(f"{ms:.3f}" for ms in jobs.ms_per_step()), file=sys.stderr)
    from perfbench.check import load_limits, verdict

    limits = load_limits(root, args.workload)

    correct = verdict(numbers, limits) and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    if args.trace:
        metrics = per_layer(bench, root, args.workload, prof.trace, driver)
    else:
        metrics = {name: {"value": value, "unit": unit_of(bench, name)}
                   for name, value in driver.end_to_end(attempted, window_s).items()}
        metrics["setup_s"] = {"value": setup_s, "unit": unit_of(bench, "setup_s")}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": kind, "count": cell["chips"], "memory_peak_bytes": memory_peak}
    if args.trace:
        result["device"]["busy_s"] = prof.trace.busy_s
        result["device"]["window_s"] = prof.trace.window_s
        result["breakdown"] = {"device_ops": prof.trace.top_ops(),
                               "idle_gaps": prof.trace.idle_gaps()}
    result["compared"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result


def unit_of(bench: Dict, name: str) -> str:
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise RunError(f"metric {name!r} is not in BENCHMARK.json")


def per_layer(bench: Dict, root: Path, workload: str, trace, driver) -> Dict:
    """Each per-layer metric listed for this cell, from its reader; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        reader = load_file(root / "perfbench" / "metrics" / f"{m['name']}.py",
                           "perfbench_metric_" + m["name"].replace(".", "_"))
        value: Optional[float] = reader.read(trace, driver)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
