"""The port's gather probes (``libre_tpu_torch/benchmarks``, ``ops/gather.py``)
against the JAX package's own probes (``benchmarks/probe_*.py``).

The reference modules are loaded by path (``benchmarks/`` is not a
package) and their ``pallas_call``s run in interpret mode on the CPU.
Two of them do work at import, which fails fast on the CPU and is caught
by their own ``try``; they are imported before ``pallas_call`` is
patched.  The same numpy-seeded inputs go through the JAX probe and
through the port probe's ``fn``, which on CPU tensors runs the plain
PyTorch version.  Tolerance: bit-equal, but P12, whose lerp XLA:CPU may
contract into a fused multiply-add: max |Δ| ≤ 1e-6.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import importlib.util
import os
from typing import Callable

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu_torch.benchmarks import MODULES
from libre_tpu_torch.benchmarks import _probe
from libre_tpu_torch.ops import gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P12_TOL = 1e-6


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX probe module ``benchmarks/<name>.py``, loaded once (its
    import-time work, where it has any, fails on the CPU and is caught)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "benchmarks", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port(name):
    return importlib.import_module(f"libre_tpu_torch.benchmarks.{name}")


@pytest.fixture()
def interpret(monkeypatch):
    """Load every reference module, then run their ``pallas_call``s in
    interpret mode, with ``probe_kernel_gather.K`` cut to 4 planes."""
    for name in MODULES:
        reference(name)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(reference("probe_kernel_gather"), "K", 4)


# ------------------------------------------------------------------ inputs
def normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def uniform(rng, shape):
    return rng.random(shape, dtype=np.float32)


def ints(rng, high, shape):
    return rng.integers(0, high, shape).astype(np.int32)


def last(i, high):
    """``i`` with its first row and its last column at the table's last
    entry ``high - 1``."""
    i = i.copy()
    i[0, :] = high - 1
    i[:, -1] = high - 1
    return i


def densities(rng, shape, edge):
    """Uniform densities in [0, 1), or with ``edge`` in [-0.5, 1.5) with
    0, -0, 1, 255/256, 256/255, -1/255 and 1.5 among them."""
    if not edge:
        return uniform(rng, shape)
    d = (rng.random(shape, dtype=np.float32) * 2.0 - 0.5).astype(np.float32)
    special = np.float32([0.0, -0.0, 1.0, 255 / 256, 256 / 255, -1 / 255, 1.5, 0.5])
    d.reshape(-1)[: special.size] = special
    return d


@dataclasses.dataclass(frozen=True)
class Case:
    """One probe: ``make(rng, edge)`` gives the numpy inputs; ``ref(x)`` the
    JAX probe's output on them; ``fn(x)`` the port probe's output."""

    make: Callable
    ref: Callable
    fn: Callable
    tol: float = 0.0


def _port_fn(module, build, *args):
    return getattr(port(module), build)(*args, device="cpu")[0]


def _args_case(module, build, make, port_args=None, ref_args=None):
    """A probe whose JAX ``fn`` is the reference's ``build()[0]`` and whose
    port ``fn`` is the port's ``build(device="cpu")[0]``, both on the same
    inputs (reordered by ``ref_args`` / ``port_args``)."""

    def ref(x):
        fn = getattr(reference(module), build)()[0]
        return fn(*(ref_args(x) if ref_args else x))

    def fn(x):
        args = port_args(x) if port_args else x
        return _port_fn(module, build)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))

    return Case(make, ref, fn)


def _take_flat(rng, edge):
    i = ints(rng, 64 ** 3, (8, 128))
    return normal(rng, (2048, 128)), last(i, 64 ** 3) if edge else i


def _along(rows, cols, high, irows=None, icols=None, table=normal):
    def make(rng, edge):
        i = ints(rng, high, (irows or rows, icols or cols))
        return table(rng, (rows, cols)), last(i, high) if edge else i
    return make


def _row_take(rng, edge):
    i = ints(rng, 4096, (1, 128))
    if edge:
        i[0, 7] = 4095
    return normal(rng, (4096, 128)), i


def _pallas_table(rng, edge):
    i = ints(rng, 32768, (1024, 128))
    return uniform(rng, (32768,)), last(i, 32768) if edge else i


def _lanes(rng, edge):
    t, i = _pallas_table(rng, edge)
    li = i[:, :1] % 128
    if edge:
        li[::3] = 127
    return np.broadcast_to(t[:128], (1024, 128)), li


def _mk_case(axis):
    return Case(
        _along(128, 128, 128, table=uniform),
        lambda x: reference("probe_gather_axis0").mk(axis)(*x),
        lambda x: _port_fn("probe_gather_axis0", "mk", axis)(*map(torch.from_numpy, x)),
    )


def _tf_case(name, make_d, t_shape, tol=0.0):
    def make(rng, edge):
        return densities(rng, make_d, edge), uniform(rng, t_shape)

    return Case(make, lambda x: getattr(reference("probe_kernel_gather"), name)(*x),
                lambda x: _port_fn("probe_kernel_gather", name)(*map(torch.from_numpy, x)), tol)


def _onehot_make(rng, edge):
    return densities(rng, (1024, 128), edge), uniform(rng, (256, 4))


CASES = {
    "P1": _args_case("probe_gather", "build_take_flat", _take_flat),
    "P2": _args_case("probe_gather", "build_take_along_lane", _along(8, 128, 128)),
    "P3": _args_case("probe_gather", "build_take_along_sublane", _along(512, 128, 512, irows=8)),
    "P4": _args_case("probe_gather", "build_onehot_mxu", _along(512, 128, 512, irows=8)),
    "P5": _args_case("probe_gather2", "build_lane_gather_loop", _along(8, 128, 128)),
    "P6": _args_case("probe_gather2", "build_lane_gather_wide", _along(8, 1024, 1024, icols=128)),
    "P7": _args_case("probe_gather2", "build_sublane_gather_fullshape", _along(512, 128, 512)),
    "P8": _args_case("probe_gather2", "build_sublane_gather_8", _along(8, 128, 8)),
    "P9": _args_case("probe_gather2", "build_row_take", _row_take,
                     port_args=lambda x: (x[0], x[1][0, :8])),
    "P10 axis 1": _mk_case(1),
    "P10 axis 0": _mk_case(0),
    "P11": _tf_case("f1", (4, 64, 256), (256,)),
    "P12": _tf_case("f2", (4, 64, 256), (4, 256), tol=P12_TOL),
    "P13": _tf_case("f3", (64, 512), (256,)),
    "P14": _args_case("probe_pallas_gather", "build_take_flat", _pallas_table),
    "P15": _args_case("probe_pallas_gather", "build_take_2d_table", _pallas_table,
                      port_args=lambda x: (x[0].reshape(256, 128), x[1] // 128, x[1] % 128),
                      ref_args=lambda x: (x[0].reshape(256, 128), x[1] // 128, x[1] % 128)),
    "P16": _args_case("probe_pallas_gather", "build_take_along_lanes", _lanes),
    "P17": _args_case("probe_pallas_gather", "build_onehot_tf", _onehot_make,
                      ref_args=lambda x: (x[1], x[0])),
}
# Inputs the reference's own never reach: indices at the table's last row
# and lane, loop sums that wrap at every start, densities outside [0, 1).
EDGES = ("P1", "P2", "P3", "P5", "P6", "P7", "P8", "P9", "P10 axis 0", "P11", "P12", "P13",
         "P14", "P15", "P16", "P17")


@pytest.mark.parametrize(
    "probe, edge",
    [(p, False) for p in CASES] + [(p, True) for p in EDGES],
    ids=lambda v: v if isinstance(v, str) else ("edge" if v else "seeded"),
)
def test_probe_matches_jax(interpret, probe, edge):
    case = CASES[probe]
    rng = np.random.default_rng(0)
    x = case.make(rng, edge)
    want = np.asarray(case.ref(tuple(jnp.asarray(a) for a in x)))
    got = case.fn(x).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if case.tol:
        np.testing.assert_allclose(got, want, rtol=0, atol=case.tol)
    else:
        np.testing.assert_array_equal(got, want)


def test_edge_densities_clip_and_zero():
    """P11/P13 clip a density below 0 or at and above 1 into the table;
    P17 gives zeros for it."""
    d = torch.tensor([-0.5, -1 / 255, 0.0, 1.0, 1.5], dtype=torch.float32)
    tf = torch.arange(1.0, 257.0).reshape(256, 1).repeat(1, 4)
    near = gather.tf_nearest(d, tf[:, 0].contiguous(), scale=256.0, outside="clip")
    assert near.tolist() == [1.0, 1.0, 1.0, 256.0, 256.0]
    zero = gather.tf_nearest(d, tf, scale=255.0, outside="zero")
    assert zero[:, 0].tolist() == [0.0, 0.0, 1.0, 256.0, 0.0]


@pytest.mark.parametrize("name", MODULES)
def test_port_module_mirrors_reference(name):
    """Every reference ``build_*`` function that reaches ``pallas_call`` has its
    namesake in the port module, and the module's probes name the
    reference's ``pallas_call`` lines."""
    ref = reference(name)
    mod = port(name)
    names = [n for n in vars(ref) if n.startswith("build_") and not n.startswith("build_xla")]
    names += [n for n in ("mk", "f1", "f2", "f3") if n in vars(ref)]
    assert names and all(callable(getattr(mod, n, None)) for n in names)
    with open(os.path.join(ROOT, "benchmarks", f"{name}.py")) as f:
        lines = f.read().splitlines()
    for p in mod.PROBES:
        path, line = p.replaces.split(":")
        assert path == f"benchmarks/{name}.py"
        assert "pallas_call" in lines[int(line) - 1], p


def test_probe_ids_cover_every_pallas_call():
    ids = [p.id for name in MODULES for p in port(name).PROBES]
    assert ids == [f"P{n}" for n in range(1, 10)] + ["P10 axis 1", "P10 axis 0"] + [
        f"P{n}" for n in range(11, 18)]
    sites = {p.replaces for name in MODULES for p in port(name).PROBES}
    calls = {f"benchmarks/{name}.py:{n}" for name in MODULES
             for n, text in enumerate(open(os.path.join(ROOT, "benchmarks", f"{name}.py")), 1)
             if "pallas_call(" in text}
    assert sites == calls


@pytest.mark.parametrize("name", MODULES)
def test_main_raises_without_a_card(name):
    """The probe mains time CUDA kernels: on the CPU they raise before
    running anything."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port(name).main(device="cpu")


@pytest.mark.parametrize("name", MODULES)
def test_builds_are_seeded(name):
    """Each probe's inputs come from its seed alone, and its ``fn`` on CPU
    tensors is the plain version."""
    for p in port(name).PROBES:
        fn, args, work = p.build(device="cpu", seed=3)
        _fn, again, _work = p.build(device="cpu", seed=3)
        assert all(torch.equal(a, b) for a, b in zip(args, again)) and work > 0
        assert torch.equal(fn(*args), _probe.plain_of(fn)(*args))


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


REJECTED = {
    "take int64 index": lambda: gather.take(torch.zeros(8), torch.zeros(4, dtype=torch.int64)),
    "take f64 table": lambda: gather.take(torch.zeros(8, dtype=torch.float64), _i32(4)),
    "take strided table": lambda: gather.take(torch.zeros(8, 8).t(), _i32(4)),
    "take partial rows": lambda: gather.take(torch.zeros(10), _i32(2), row=4),
    "take lane with rows": lambda: gather.take(torch.zeros(4, 8), _i32(2), _i32(2), row=2),
    "take_along 3-D": lambda: gather.take_along(torch.zeros(2, 2, 2), _i32(2, 2), 1),
    "take_along off-axis shape": lambda: gather.take_along(torch.zeros(8, 4), _i32(4, 4), 1),
    "take_along mod past table": lambda: gather.take_along(torch.zeros(8, 4), _i32(8, 4), 1,
                                                           loop=2, mod=5),
    "take_along axis 2": lambda: gather.take_along(torch.zeros(8, 4), _i32(8, 4), 2),
    "tf_nearest outside": lambda: gather.tf_nearest(torch.zeros(4), torch.zeros(8), scale=8.0,
                                                    outside="wrap"),
    "tf_nearest big table": lambda: gather.tf_nearest(torch.zeros(4), torch.zeros(4096, 4),
                                                      scale=1.0),
    "tf_linear 1-D table": lambda: gather.tf_linear(torch.zeros(2, 4), torch.zeros(8)),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        REJECTED[case]()


@pytest.mark.parametrize("loop, mod", [(1, None), (1, 5), (3, 8), (9, 8)])
def test_take_along_loop_order(loop, mod):
    """The loop sum adds from 0 in the order of k, the plain version's
    Python loop, and wraps with a floored modulo."""
    rng = np.random.default_rng(1)
    table = torch.from_numpy(normal(rng, (6, 8)))
    idx = torch.from_numpy(rng.integers(-20, 20, (6, 5)).astype(np.int32))
    if mod is None:
        idx = idx.clamp(0, 7)
    got = gather.take_along(table, idx, 1, loop=loop, mod=mod)
    t, i = table.numpy(), idx.numpy()
    want = np.zeros(i.shape, np.float32)
    for k in range(loop):
        j = i + k if mod is None else (i + k) % mod
        v = np.take_along_axis(t, j, axis=1)
        want = v if loop == 1 else want + v
    np.testing.assert_array_equal(got.numpy(), want)
