"""A training window runs whole jobs from one start: at a tiny size on the
CPU, each job's steps repeat the first job's losses (the set-up's checked
steps among them), whatever came before, and the selection that decides
the store takes only the finest level."""

import json

import pytest
import torch

from perfbench import harness


def driver_of(root, cell, seed=2147483702):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    mod = harness.load_file(root / "perfbench" / "drivers" / f"{traffic['driver']}.py",
                            "perfbench_driver_" + traffic["driver"])
    return mod.Driver(config, traffic, seed, torch.device("cpu")), traffic


def losses_of_units(driver, n):
    """The loss of each of the next ``n`` window steps."""
    seen = []
    steps = driver.steps if hasattr(driver, "steps") else None
    if steps is None:
        real = driver.step
        driver.step = lambda *a: seen.append(float(real(*a))) or torch.tensor(seen[-1])
    else:
        def wrap(f):
            return lambda *a: seen.append(float(f(*a))) or torch.tensor(seen[-1])

        driver.steps = [wrap(f) for f in steps]
    for _ in range(n):
        assert driver.unit()
    return seen


@pytest.mark.parametrize("cell", ["fit.store512", "fit.exact512"])
def test_every_job_repeats_the_first(tiny_root, cell):
    driver, traffic = driver_of(tiny_root, cell)
    driver.setup()
    job, checked = traffic["job_steps"], traffic["checked_steps"]
    rest_of_first = job - checked
    seen = losses_of_units(driver, rest_of_first + 2 * job)
    first = driver.readings["losses"] + seen[:rest_of_first]
    second, third = seen[rest_of_first:rest_of_first + job], seen[rest_of_first + job:]
    assert second == pytest.approx(first, rel=1e-6)
    assert third == pytest.approx(first, rel=1e-6)
    assert len(driver.jobs.ms_per_step()) == 1  # the jobs between two restarts
    assert first[0] != pytest.approx(first[-1], rel=1e-3)  # the job does fit


def test_store_is_the_finest_level_the_views_select(tiny_root):
    driver, _ = driver_of(tiny_root, "fit.store512")
    driver.cfg = dict(driver.cfg, screen_space_error=64.0)
    with pytest.raises(ValueError, match="bricks at levels"):
        driver.setup()
