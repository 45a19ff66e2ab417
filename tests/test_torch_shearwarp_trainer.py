"""The port's dense shear-warp trainer (``train/shearwarp_trainer``)
against the JAX package's, on the CPU, at the JAX test's size
(tests/test_shearwarp_trainer.py: a 12³ volume, 16 planes, 16² slope
grids, two views): the same seeded numpy inputs through both.

* the plans equal the JAX plans (and ``interop.shearwarp_problem_from_jax``
  gives the port's problem back);
* ``render_views`` against the JAX ``render_views(None, ...)`` within
  2e-5, "pre" and "post";
* the loss within 1e-5 and both leaves' gradients within 1e-4 of the
  largest entry, against ``jax.grad``;
* 3 SGD steps against ``optax.sgd`` and 3 Adam steps against
  ``optax.adam`` (``torch.optim.Adam`` is the same bias-corrected
  update), each followed by the [0, 1] clamp, within 1e-5 elementwise;
* ``fit`` cuts the loss by more than 10× in 60 steps (the JAX test's
  criterion) and leaves both leaves in [0, 1];
* ``mesh=`` takes a ``parallel.mesh.Mesh``: over a 2 × 2 mesh of CPU
  shards ``render_views`` equals JAX's ``render_views(mesh, ...)`` ("pre",
  the JAX sharded pipeline's classification) within 2e-5, and ``fit``
  takes the one-device steps;
* the TF lookup's gather (``transfer_function._TakeRows``, whose backward
  sums by ``torch.bincount``) gives autograd's own ``tf[idx]`` values bit
  for bit and its TF gradient within 1e-6 of the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as RenderParamsJ
from libre_tpu.train import shearwarp_trainer as swt_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops.reference import RenderParams as RenderParamsT
from libre_tpu_torch.train import shearwarp_trainer as swt_t
from tests.test_torch_exact import cameras

torch.set_num_threads(1)

GMIN, GMAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)
EYES = ([0.2, 0.1, 1.4], [1.4, 0.1, 0.2])
PARAMS = dict(n_samples_per_ray=16, data_source_range=(0.0, 1.0), filter_mode="trilinear")
N = 12
TOL_RENDER = 2e-5
TOL_GRAD = 1e-4
TOL_STEP = 1e-5


def problems(classification="pre", n_views=2):
    """(JAX problem, port problem) over the same cameras."""
    cams = [cameras(e, img=32) for e in EYES[:n_views]]
    swp = dict(n_planes=16, inter_size=(16, 16), classification=classification)
    pj = swt_j.ShearWarpProblem.from_cameras(
        [c[0] for c in cams], GMIN, GMAX, RenderParamsJ(**PARAMS), sw_j.ShearWarpParams(**swp))
    pt = swt_t.ShearWarpProblem.from_cameras(
        [c[1] for c in cams], GMIN, GMAX, RenderParamsT(**PARAMS), sw_t.ShearWarpParams(**swp))
    return pj, pt


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((N,) * 3, dtype=np.float32), tf_j.default_color_map(32)


def test_plans_match_jax():
    pj, pt = problems()
    assert pt.params.early_exit == pj.params.early_exit == 1.1
    copied = interop.shearwarp_problem_from_jax(pj)
    for port in (pt, copied):
        assert len(port.plans) == len(pj.plans)
        for a, b in zip(port.plans, pj.plans):
            assert (a.axis, a.sign) == (b.axis, b.sign)
            np.testing.assert_allclose(a.bounds, b.bounds, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a.eye, b.eye)
            np.testing.assert_allclose(a.u, b.u, rtol=0, atol=1e-6)
            np.testing.assert_allclose(a.v, b.v, rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a.valid, b.valid)
        assert port.swp == pt.swp and port.params == pt.params
        np.testing.assert_array_equal(port.world_min, GMIN)


@pytest.mark.parametrize("classification", ["pre", "post"])
def test_render_views_match_jax(classification):
    pj, pt = problems(classification)
    vol, tf = inputs()
    want = pj.render_views(None, jnp.asarray(vol), jnp.asarray(tf))
    got = pt.render_views(None, torch.from_numpy(vol), torch.from_numpy(tf))
    for g, w in zip(got, want):
        assert g.shape == (16, 16, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_RENDER)
        assert np.asarray(w)[..., 3].max() > 0.1


def _loss_j(problem, targets):
    def loss(v, t):
        imgs = problem.render_views(None, v, t)
        return sum(jnp.mean((i - g) ** 2) for i, g in zip(imgs, targets)) / len(imgs)
    return loss


@pytest.mark.parametrize("classification", ["pre", "post"])
def test_loss_and_gradients_match_jax(classification):
    pj, pt = problems(classification)
    vol, tf = inputs(1)
    targets = [np.array(t) for t in pj.render_views(None, *map(jnp.asarray, inputs(2)))]
    loss_w, (gv_w, gt_w) = jax.value_and_grad(_loss_j(pj, targets), argnums=(0, 1))(
        jnp.asarray(vol), jnp.asarray(tf))
    params = {"volume": torch.from_numpy(vol).requires_grad_(),
              "tf": torch.from_numpy(tf).requires_grad_()}
    opt = torch.optim.SGD([params["volume"], params["tf"]], lr=0.0)
    loss = swt_t.make_train_step(pt, opt)(params, [torch.from_numpy(t) for t in targets])
    assert abs(float(loss) - float(loss_w)) <= 1e-5
    for got, want in ((params["volume"].grad, gv_w), (params["tf"].grad, gt_w)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got.numpy() - want).max() / scale <= TOL_GRAD


OPTIMIZERS = {
    # name: (optax transform, torch optimizer factory)
    "sgd": (optax.sgd(0.5), lambda p: torch.optim.SGD(p, lr=0.5)),
    "adam": (optax.adam(3e-2), lambda p: torch.optim.Adam(p, lr=3e-2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_three_steps_match_optax(name):
    """3 steps of each optimizer from the same start to the same targets,
    each followed by the clamp: both leaves within 1e-5 elementwise, and
    every step's loss."""
    pj, pt = problems("post")
    vol, tf = inputs(3)
    targets = [np.array(t) for t in pj.render_views(None, *map(jnp.asarray, inputs(4)))]
    tx, make_opt = OPTIMIZERS[name]
    step_j = swt_j.make_train_step(pj, tx)
    params_j = {"volume": jnp.asarray(vol), "tf": jnp.asarray(tf)}
    state_j = tx.init(params_j)
    params_t = {"volume": torch.from_numpy(vol.copy()).requires_grad_(),
                "tf": torch.from_numpy(tf.copy()).requires_grad_()}
    step_t = swt_t.make_train_step(pt, make_opt([params_t["volume"], params_t["tf"]]))
    targets_j = [jnp.asarray(t) for t in targets]
    targets_t = [torch.from_numpy(t) for t in targets]
    for _ in range(3):
        params_j, state_j, loss_j = step_j(params_j, state_j, targets_j)
        loss_t = step_t(params_t, targets_t)
        assert abs(float(loss_t) - float(loss_j)) <= TOL_STEP
    for k in ("volume", "tf"):
        got = params_t[k].detach().numpy()
        np.testing.assert_allclose(got, np.asarray(params_j[k]), rtol=0, atol=TOL_STEP)
        assert got.min() >= 0.0 and got.max() <= 1.0
    assert np.abs(params_t["volume"].detach().numpy() - vol).max() > 1e-3  # the steps moved it


def test_fit_recovers_target_views():
    """A flat 0.5 volume and a grayscale TF fitted to frames of a random
    volume under the default colormap: the loss falls by more than 10× in
    60 Adam steps (tests/test_shearwarp_trainer.py:61-83)."""
    _pj, pt = problems()
    true_vol, true_tf = inputs(1)
    targets = pt.render_views(None, torch.from_numpy(true_vol), torch.from_numpy(true_tf))
    params, losses = swt_t.fit(
        pt, [t.detach() for t in targets], np.full((N,) * 3, 0.5, np.float32),
        tf_j.grayscale_ramp(32), device="cpu", steps=60,
    )
    assert losses[-1] < losses[0] / 10, (losses[0], losses[-1])
    assert params["volume"].shape == (N,) * 3
    for p in params.values():
        assert float(p.detach().min()) >= 0.0 and float(p.detach().max()) <= 1.0


def test_mesh_raises():
    from libre_tpu.parallel import make_mesh as make_mesh_j
    from libre_tpu_torch.parallel import make_mesh

    pj, pt = problems(n_views=1)
    vol, tf = inputs()
    with pytest.raises(TypeError, match="Mesh"):
        pt.render_views(object(), torch.from_numpy(vol), torch.from_numpy(tf))
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    with pytest.raises(TypeError, match="Mesh"):
        swt_t.make_train_step(pt, opt, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        swt_t.fit(pt, [], vol, tf, device="cpu", mesh=object(), steps=1)
    mesh = make_mesh(n_brick=2, n_ray=2, devices=["cpu"] * 4)
    want = pj.render_views(make_mesh_j(n_brick=2, n_ray=2), jnp.asarray(vol), jnp.asarray(tf))
    got = pt.render_views(mesh, torch.from_numpy(vol), torch.from_numpy(tf))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    targets = [t * 0.5 for t in pt.render_views(None, torch.from_numpy(vol), torch.from_numpy(tf))]
    runs = [swt_t.fit(pt, targets, np.full_like(vol, 0.5), tf, device="cpu", mesh=m, steps=2,
                      optimizer=lambda p: torch.optim.SGD(p, lr=1.0)) for m in (None, mesh)]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-5)


@pytest.mark.parametrize("n_tf", [32, 256])
def test_take_rows_matches_autograd_indexing(n_tf):
    from libre_tpu_torch.ops import transfer_function as tfm

    rng = np.random.default_rng(3)
    density = torch.from_numpy(rng.uniform(-0.1, 1.1, (7, 9, 11)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((7, 9, 11, 4)).astype(np.float32))
    outs = []
    for take in (tfm._TakeRows.apply, lambda table, idx: table[idx]):
        tf = torch.from_numpy(tf_j.grayscale_ramp(n_tf) * 0.7 + 0.1).requires_grad_()
        real = tfm._TakeRows
        tfm._TakeRows = type("Take", (), {"apply": staticmethod(take)})
        try:
            out = tfm.lookup(tf, density)
        finally:
            tfm._TakeRows = real
        (d_tf,) = torch.autograd.grad(out, [tf], g)
        outs.append((out.detach(), d_tf))
    (out_b, d_b), (out_i, d_i) = outs
    assert torch.equal(out_b, out_i)
    assert float((d_b - d_i).abs().max()) <= 1e-6 * float(d_i.abs().max())
