"""The port's exact trainer (``libre_tpu_torch.train.trainer``) against the
JAX package's ``make_exact_train_step`` (its Pallas forward and backward
in interpret mode), on a 16³ volume, 16² rays, 32 samples per ray,
trilinear, early exit off.

Both start from the same state, carried across by
``interop.exact_params_from_jax``, and fit a target rendered from a
smooth ground truth.  Three ``torch.optim.SGD`` steps (lr 5) equal three
``optax.sgd`` steps elementwise within 1e-5 (losses rtol 1e-5; the
largest difference seen is 4.5e-7 while the steps move the density by
0.033 and the TF by 0.14).  A larger step (lr 20) moves a voxel across
a gate of the gradient (a TF texel, the [0, 1] clamp) in one package
and not the other by its third step, and the two then differ by 4.5e-3
there.  Adam is held to lowering the loss, not compared elementwise
(m/√v turns tiny gradient differences into whole learning-rate steps).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libre_tpu.ops import exact_pallas as ep_j
from libre_tpu.train import trainer as trainer_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops import exact
from libre_tpu_torch.testing import smooth_volume
from libre_tpu_torch.train import TrainState, init_exact_state, make_exact_train_step
from tests.test_torch_exact import cameras
from tests.test_torch_exact_grad import GMAX, GMIN, scene

torch.set_num_threads(1)

EYES = [[0.1, 0.05, 1.4], [-0.15, 0.1, 1.3]]  # benchmarks/demo_inverse_render.py:34-37


def views(params_t, device="cpu"):
    return [
        exact.exact_view(cameras(e, img=16)[1], params_t, GMIN, GMAX, device=device)
        for e in EYES
    ]


def targets(views_t):
    """Renders of ``smooth_volume(16)`` under the default TF."""
    _vol, tf, _gw, _p_j, _p_t = scene()
    gt = smooth_volume(16, seed=7, device="cpu")
    with torch.no_grad():
        return [exact.render_exact_diff(gt, torch.from_numpy(tf), v) for v in views_t]


def start(seed=1):
    """A flat-ish initial density and a TF with no entry at 0 or 1."""
    rng = np.random.default_rng(seed)
    _vol, tf, _gw, p_j, p_t = scene()
    density = (0.5 + 0.05 * rng.standard_normal((16, 16, 16))).astype(np.float32)
    tf0 = np.clip(tf * 0.7 + 0.05, 0.0, 1.0).astype(np.float32)
    return density, tf0, p_j, p_t


def test_sgd_steps_match_optax():
    """Three SGD steps of the port's exact trainer == three of the JAX
    one's with ``optax.sgd``: gradients, update and TF clamp."""
    density, tf0, p_j, p_t = start()
    view = views(p_t)[0]
    target = targets([view])[0]
    lr = 5.0
    opt_j = optax.sgd(lr)
    state_j = trainer_j.init_exact_state(jnp.asarray(density), jnp.asarray(tf0), opt_j)
    plan = ep_j.plan_exact(cameras(EYES[0], img=16)[0], p_j, GMIN, GMAX, density.shape)
    step_j = trainer_j.make_exact_train_step(plan, opt_j, interpret=True)

    carried = interop.exact_params_from_jax(state_j.params)
    state_t = init_exact_state(
        carried["density"], carried["tf"], lambda p: torch.optim.SGD(p, lr=lr), device="cpu"
    )
    step_t = make_exact_train_step(view)
    losses_j, losses_t = [], []
    for _ in range(3):
        state_j, loss_j = step_j(state_j, jnp.asarray(target.numpy()))
        losses_j.append(float(loss_j))
        losses_t.append(float(step_t(state_t, target)))
    assert state_t.step == 3
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    want = interop.exact_params_from_jax(state_j.params)
    got = {k: v.detach().numpy() for k, v in state_t.params.items()}
    assert np.abs(got["density"] - density).max() > 1e-2  # the steps moved it
    np.testing.assert_allclose(got["density"], want["density"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["tf"], want["tf"], rtol=0, atol=1e-5)


def test_adam_lowers_the_loss():
    """Adam (lr 5e-2, the demo's) over two views, alternating: view 0's
    loss falls by more than half in 8 steps."""
    density, tf0, _p_j, p_t = start()
    views_t = views(p_t)
    targets_t = targets(views_t)
    state = init_exact_state(
        density, tf0, lambda p: torch.optim.Adam(p, lr=5e-2), device="cpu"
    )
    steps = [make_exact_train_step(v) for v in views_t]
    losses = [float(steps[i % 2](state, targets_t[i % 2])) for i in range(9)]
    assert all(math.isfinite(x) for x in losses)
    assert losses[8] < losses[0] / 2, losses


def test_tf_stays_clamped():
    """A step large enough to push TF entries out of [0, 1] leaves them
    clamped there; the density is not clamped."""
    density, tf0, _p_j, p_t = start()
    view = views(p_t)[0]
    target = targets([view])[0]
    state = init_exact_state(density, tf0, lambda p: torch.optim.SGD(p, lr=5e3), device="cpu")
    make_exact_train_step(view)(state, target)
    tf = state.params["tf"].detach()
    assert float(tf.min()) == 0.0 and float(tf.max()) == 1.0
    d = state.params["density"].detach()
    assert float(d.min()) < 0.0 or float(d.max()) > 1.0


def test_state_and_loss_fn():
    """``init_exact_state`` builds the optimizer over the two leaves on
    the device asked for; a custom ``loss_fn`` is used."""
    density, tf0, _p_j, p_t = start()
    view = views(p_t)[0]
    state = init_exact_state(density, tf0, lambda p: torch.optim.SGD(p, lr=0.0), device="cpu")
    assert isinstance(state, TrainState) and state.step == 0
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == [
        state.params["density"], state.params["tf"]
    ]
    assert state.params["density"].device.type == "cpu"
    seen = []

    def loss_fn(out, target):
        seen.append(tuple(out.shape))
        return out.sum() * 0.0

    loss = make_exact_train_step(view, loss_fn)(state, torch.zeros(view.n_rays, 4))
    assert seen == [(view.n_rays, 4)] and float(loss) == 0.0
    bad = exact.exact_view(
        cameras(EYES[0], img=16)[1], dataclasses.replace(p_t, early_exit=0.999),
        GMIN, GMAX, device="cpu",
    )
    with pytest.raises(ValueError, match="early_exit"):
        make_exact_train_step(bad)(state, torch.zeros(bad.n_rays, 4))
