"""The port's store trainer (libre_tpu_torch.train.store_trainer) against
the JAX package's single-device trainer, on the tests/test_store_trainer.py
scene (N = 16, 2 views of 16×12 rays, K = 32 planes).

The JAX side runs its Pallas forward and backward in interpret mode; the
port runs on CPU tensors (the kernels' plain versions).  Loss rtol 1e-5;
gradients, normalised by their max |·|, 1e-4; three SGD steps elementwise
atol 1e-5.  Adam is not compared elementwise: where a gradient is near
zero, m/√v is ±1 for any tiny difference, so params may differ by a whole
learning rate; it is held to converging instead.
"""

import inspect

import numpy as np
import optax
import pytest
import torch

import jax

from libre_tpu.train import store_trainer as st_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL
from libre_tpu_torch.train import (
    StoreProblem,
    fit,
    make_store_train_step,
    restore_checkpoint,
    save_checkpoint,
)
from libre_tpu_torch.train import store_trainer as st_t
from tests.test_store_trainer import make_problem

torch.set_num_threads(1)


def port_scene(diff_tf):
    """(JAX problem, store, tf), (port problem, store, tf)."""
    problem_j, store_j, tf_j = make_problem(n_views=2, diff_tf=diff_tf)
    problem_t = interop.store_problem_from_jax(problem_j)
    params = interop.params_from_jax(
        {"store": store_j, "tf": tf_j}, fine_dims(problem_t)
    )
    return (problem_j, store_j, tf_j), (problem_t, params["store"], params["tf"])


def fine_dims(problem: StoreProblem):
    return (problem.na_real, problem.nc_real, problem.nb_real)


def assert_close_normalised(got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("diff_tf", [True, False])
def test_loss_and_grads_match_jax(diff_tf):
    (problem_j, store_j, tf_j), (problem_t, store, tf) = port_scene(diff_tf)
    targets = st_j.render_views(problem_j, store_j * 0.0 + 0.3, tf_j)
    loss_j, (ds_j, dtf_j) = jax.value_and_grad(
        lambda s, t: st_j.make_loss_fn(problem_j, None)(s, t, targets),
        argnums=(0, 1),
    )(store_j, tf_j)

    s = torch.from_numpy(store).requires_grad_()
    t = torch.from_numpy(tf).requires_grad_()
    loss = st_t.make_loss_fn(problem_t)(s, t, torch.from_numpy(np.array(targets)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    ds_j = interop.store_grad_from_jax(np.asarray(ds_j), fine_dims(problem_t))
    assert_close_normalised(s.grad.numpy(), ds_j, 1e-4)
    if diff_tf:
        assert_close_normalised(t.grad.numpy(), np.asarray(dtf_j), 1e-4)
    else:
        assert t.grad is None


def test_sgd_steps_match_optax():
    """Three SGD steps of the port's ``fit`` == three of the JAX ``fit``
    with ``optax.sgd``, elementwise: gradients, update, clamp and
    SENTINEL pinning all agree."""
    (problem_j, store_j, tf_j), (problem_t, store, tf) = port_scene(True)
    targets = st_j.render_views(problem_j, store_j, tf_j)
    rng = np.random.default_rng(0)
    covered = np.asarray(store_j) > -0.5
    init_store = np.where(
        covered,
        np.clip(np.asarray(store_j) + rng.normal(0, 0.2, store_j.shape), 0, 1),
        SENTINEL,
    ).astype(np.float32)
    init_tf = np.clip(np.asarray(tf_j) * 0.7 + 0.05, 0.0, 1.0).astype(np.float32)
    lr = 10.0
    params_j, losses_j = st_j.fit(
        problem_j, targets, init_store, init_tf, mesh=None,
        optimizer=optax.sgd(lr), steps=3,
    )
    params_t, losses_t = fit(
        problem_t, np.array(targets),
        interop.store_from_jax(init_store, fine_dims(problem_t)), init_tf,
        device="cpu", optimizer=lambda p: torch.optim.SGD(p, lr=lr), steps=3,
    )
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = interop.params_from_jax(params_j, fine_dims(problem_t))
    got_store = params_t["store"].detach().numpy()
    start = interop.store_from_jax(init_store, fine_dims(problem_t))
    assert np.abs(got_store - start).max() > 1e-2  # the steps moved the store
    np.testing.assert_allclose(got_store, want["store"], atol=1e-5)
    np.testing.assert_allclose(params_t["tf"].detach().numpy(), want["tf"], atol=1e-5)


def test_adam_recovers_store_and_pins_sentinel():
    """Recover the density store from 2 views with Adam (TF frozen): the
    loss drops more than 10× in 25 steps from a flat init, and the
    uncovered (SENTINEL) voxels never move."""
    _, (problem, store_gt, tf) = port_scene(False)
    store_gt = store_gt.copy()
    store_gt[4:8, 4:8, 4:8] = SENTINEL  # a hole no brick covers
    targets = st_t.render_views(problem, torch.from_numpy(store_gt), torch.from_numpy(tf))
    covered = store_gt > -0.5
    init = np.where(covered, 0.5, SENTINEL).astype(np.float32)
    params, losses = fit(
        problem, targets, init, tf, device="cpu",
        optimizer=lambda p: torch.optim.Adam(p, lr=5e-2), steps=25,
    )
    assert losses[-1] < losses[0] / 10.0, losses
    store = params["store"].detach().numpy()
    assert np.all(store[~covered] == SENTINEL)
    assert store[covered].min() >= 0.0 and store[covered].max() <= 1.0
    np.testing.assert_array_equal(params["tf"].detach().numpy(), tf)  # frozen


def test_checkpoint_round_trip(tmp_path):
    """Params and Adam state restored from a checkpoint continue exactly
    as the run that saved them."""
    _, (problem, store, tf) = port_scene(True)
    targets = st_t.render_views(problem, torch.from_numpy(store), torch.from_numpy(tf))

    def start(store0, tf0):
        params = {
            "store": torch.as_tensor(store0).clone().requires_grad_(),
            "tf": torch.as_tensor(tf0).clone().requires_grad_(),
        }
        opt = torch.optim.Adam([params["store"], params["tf"]], lr=2e-2)
        return params, opt, make_store_train_step(problem, opt)

    params, opt, step = start(np.clip(store * 0.8 + 0.1, 0, 1), tf * 0.9)
    for _ in range(2):
        step(params, targets)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, params, opt)

    restored = restore_checkpoint(path, device="cpu")
    params2, opt2, step2 = start(restored["store"], restored["tf"])
    restore_checkpoint(path, opt2, device="cpu")
    for k in params:
        assert torch.equal(params[k].detach(), params2[k].detach())
    step(params, targets)
    step2(params2, targets)
    for k in params:
        assert torch.equal(params[k].detach(), params2[k].detach())


def test_restore_checkpoint_device(tmp_path):
    """``restore_checkpoint`` loads onto the card unless asked for the CPU;
    asked for it, it returns CPU tensors equal to those saved."""
    path = str(tmp_path / "params.pt")
    saved = {"store": torch.linspace(0.0, 1.0, 12).reshape(2, 6), "tf": torch.ones(256, 4)}
    save_checkpoint(path, saved)
    restored = restore_checkpoint(path, device="cpu")
    assert sorted(restored) == ["store", "tf"]
    for k, v in restored.items():
        assert v.device.type == "cpu" and torch.equal(v, saved[k])
    assert inspect.signature(restore_checkpoint).parameters["device"].default == "cuda"


def test_sharded_trainers_are_m9():
    _, (problem, _store, _tf) = port_scene(True)
    with pytest.raises(TypeError, match="Mesh"):
        st_t.make_loss_fn(problem, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        st_t.make_slab_loss_fn(problem, mesh=object())
