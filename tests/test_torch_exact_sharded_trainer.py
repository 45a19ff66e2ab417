"""The port's mesh-sharded exact trainer (``train.trainer``:
``InverseRenderProblem``, ``init_state``, ``make_train_step``) against the
JAX package's on the CPU.

The problem of tests/test_train.py: the 16³ smoothed volume in 2³ bricks
with two ghost voxels, sorted front to back and split over 2 brick
shards, its 24² ``CAMERA``, 24 samples per ray, trilinear, the early exit
off (1.1), the truth's TF the 32-entry default colormap; the estimate
starts from a 0.3 density and the 32-entry grayscale ramp.  The JAX
problem and state are carried across by ``interop``; the target is the
port's render of the truth, handed to both.

* Two SGD steps (lr 5: the density moves by up to a few 1e-2) on
  ``cpu_mesh(2, 1)`` and ``cpu_mesh(2, 2)`` against the JAX
  ``make_train_step`` on a (2 brick × 1 ray) mesh of its 8 virtual
  devices: each loss within 1e-5 relative, each density and TF entry
  within 1e-5 after the steps.
* The JAX test's loss drop: 36 Adam steps at lr 3e-2, the last loss under
  a tenth of the first.
* Each density leaf is its brick shard's chunk, on that shard's device,
  its own tensor, and takes its own gradient.
* The sharded state (per-shard leaves, the TF, Adam's moments)
  round-trips through ``save_checkpoint`` / ``restore_checkpoint``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from libre_tpu.ops import rays as rays_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as ParamsJ
from libre_tpu.ops.reference import max_steps_for_bricks
from libre_tpu.parallel import make_mesh as make_mesh_j
from libre_tpu.parallel import shard_bricks_front_to_back
from libre_tpu.train import InverseRenderProblem as ProblemJ
from libre_tpu.train import make_train_step as make_train_step_j
from libre_tpu.train.trainer import init_state as init_state_j
from libre_tpu_torch import interop
from libre_tpu_torch.parallel import make_mesh
from libre_tpu_torch.train import (
    init_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from tests.test_reference_marcher import CAMERA, GLOBAL_MAX, GLOBAL_MIN, _split_into_bricks, make_volume

torch.set_num_threads(1)
CPU = torch.device("cpu")
SGD_LR = 5.0
STEPS = 2
TOL_LOSS = 1e-5
TOL_PARAM = 1e-5


def cpu_mesh(n_brick, n_ray):
    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[CPU] * (n_brick * n_ray))


@pytest.fixture(scope="module")
def setup():
    """(JAX problem from a 0.3 density, the port's, eye/dirs/tnp as
    (JAX, torch) pairs, the target (R, 4) numpy)."""
    bricks = _split_into_bricks(make_volume(16, seed=5), 2, overlap=2)
    eye, dirs, cos_z, _ = rays_j.make_rays(CAMERA.inv_proj, CAMERA.inv_mv, CAMERA.viewport)
    dirs = dirs.reshape(-1, 3)
    tnp = rays_j.near_plane_t(cos_z.reshape(-1), CAMERA.near)
    sharded, _ = shard_bricks_front_to_back(bricks, np.asarray(eye), 2)
    params = ParamsJ(n_samples_per_ray=24, data_source_range=(0.0, 1.0),
                     filter_mode="trilinear", early_exit=1.1, remat=True)
    truth_j = ProblemJ(
        bricks=sharded, global_min=GLOBAL_MIN, global_max=GLOBAL_MAX, params=params,
        max_steps=max_steps_for_bricks(sharded.world_min, sharded.world_max, params.step_size),
    )
    truth_t = interop.inverse_render_problem_from_jax(truth_j, width=CAMERA.viewport[2],
                                                      device="cpu")
    rays_t = tuple(torch.from_numpy(np.array(x)) for x in (eye, dirs, tnp))
    with torch.no_grad():
        target = truth_t.render(cpu_mesh(2, 1), truth_t.bricks.data,
                                torch.from_numpy(tf_j.default_color_map(32)), *rays_t).numpy()
    problem_j = dataclasses.replace(
        truth_j, bricks=sharded._replace(data=jnp.full_like(sharded.data, 0.3)))
    problem_t = interop.inverse_render_problem_from_jax(problem_j, width=CAMERA.viewport[2],
                                                        device="cpu")
    return problem_j, problem_t, (eye, dirs, tnp), rays_t, target


@pytest.fixture(scope="module")
def jax_run(setup):
    """The JAX trainer's losses and state after ``STEPS`` SGD steps."""
    problem_j, _pt, rays, _rt, target = setup
    mesh = make_mesh_j(n_brick=2, n_ray=1)
    opt = optax.sgd(SGD_LR)
    state = init_state_j(problem_j, tf_j.grayscale_ramp(32), opt, mesh=mesh)
    # A committed step counter, as the step returns it: one compile.
    state = dataclasses.replace(state, step=jax.device_put(state.step, NamedSharding(mesh, P())))
    step = make_train_step_j(problem_j, opt, mesh)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, *rays, jnp.asarray(target))
        losses.append(float(loss))
    return losses, state


@pytest.mark.parametrize("n_brick,n_ray", [(2, 1), (2, 2)])
def test_train_steps_match_jax(setup, jax_run, n_brick, n_ray):
    _pj, problem_t, _rays, rays_t, target = setup
    want_losses, state_j = jax_run
    mesh = cpu_mesh(n_brick, n_ray)
    sgd = functools.partial(torch.optim.SGD, lr=SGD_LR)
    state = init_state(problem_t, tf_j.grayscale_ramp(32), sgd, mesh=mesh)
    start = [d.detach().clone() for d in state.params["density"]]
    step = make_train_step(problem_t, sgd, mesh)
    losses = [float(step(state, *rays_t, torch.from_numpy(target))) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, want_losses, rtol=TOL_LOSS)
    assert losses[1] < losses[0] and state.step == STEPS
    want = interop.train_params_from_jax(state_j.params, mesh)
    moved = max(float((d.detach() - s).abs().max())
                for d, s in zip(state.params["density"], start))
    assert 0.005 < moved < 0.1, moved
    for got, ref in zip(state.params["density"], want["density"]):
        assert float((got.detach() - ref).abs().max()) <= TOL_PARAM
    assert float((state.params["tf"].detach() - want["tf"]).abs().max()) <= TOL_PARAM


def test_loss_decreases_and_density_stays_sharded(setup):
    """36 Adam steps (lr 3e-2) on ``cpu_mesh(2, 1)``: the last loss under a
    tenth of the first, as tests/test_train.py asks of the JAX trainer;
    each density leaf is its shard's chunk on its device, with its own
    storage and gradient."""
    _pj, problem_t, _rays, rays_t, target = setup
    mesh = cpu_mesh(2, 1)
    adam = functools.partial(torch.optim.Adam, lr=3e-2)
    state = init_state(problem_t, tf_j.grayscale_ramp(32), adam, mesh=mesh)
    step = make_train_step(problem_t, adam, mesh)
    target = torch.from_numpy(target)
    losses = [float(step(state, *rays_t, target)) for _ in range(36)]
    assert losses[-1] < 0.1 * losses[0], losses[::10]
    assert state.step == 36
    density = state.params["density"]
    assert len(density) == 2 and len({d.data_ptr() for d in density}) == 2
    for kd, d in enumerate(density):
        assert d.is_leaf and d.device == mesh.device(0, kd)
        assert d.shape == (4, *problem_t.bricks.data.shape[1:])
        assert d.grad is not None and float(d.grad.abs().max()) > 0
    assert state.params["tf"].device == mesh.lead
    tf = state.params["tf"].detach()
    assert float(tf.min()) >= 0.0 and float(tf.max()) <= 1.0


def test_checkpoint_roundtrip(setup, tmp_path):
    """The sharded state after one Adam step round-trips: per-shard leaves
    onto their shards' devices, the TF, and Adam's moments, so the next
    step from the restored state equals the next step from the saved
    one."""
    _pj, problem_t, _rays, rays_t, target = setup
    mesh = cpu_mesh(2, 1)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    step = make_train_step(problem_t, adam, mesh)
    target = torch.from_numpy(target)
    state = init_state(problem_t, tf_j.grayscale_ramp(32), adam, mesh=mesh)
    step(state, *rays_t, target)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state.params, state.optimizer)
    fresh = init_state(problem_t, tf_j.grayscale_ramp(32), adam, mesh=mesh)
    devices = [mesh.device(0, kd) for kd in range(2)]
    restored = restore_checkpoint(path, fresh.optimizer, device=devices)
    assert [d.device for d in restored["density"]] == devices
    with torch.no_grad():
        for leaf, value in zip(fresh.params["density"], restored["density"]):
            leaf.copy_(value)
        fresh.params["tf"].copy_(restored["tf"])
    for a, b in zip(fresh.params["density"] + [fresh.params["tf"]],
                    state.params["density"] + [state.params["tf"]]):
        assert torch.equal(a, b)
    assert float(step(fresh, *rays_t, target)) == float(step(state, *rays_t, target))
    for a, b in zip(fresh.params["density"], state.params["density"]):
        assert torch.equal(a, b)
