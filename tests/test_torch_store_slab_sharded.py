"""The port's mesh-sharded store trainers against the JAX package's, on the
CPU (mirrors tests/test_store_slab_sharded.py and the sharded case of
tests/test_store_trainer.py).

The scene is tests/test_store_trainer.py's (N = 16, 2 views of 16×12
rays, K = 32, one march sign).  The JAX side: ``make_loss_fn(problem,
mesh)`` (views × rows, the store replicated) and ``make_slab_loss_fn``
(the store 1/4 per brick-axis device, ppermute halos) on a 4 × 2 (brick ×
ray) mesh of the 8 virtual CPU devices, Pallas in interpret mode.  The
port: the same losses over meshes of repeated ``cpu`` devices, K1 and K2
by their plain versions.  Bounds: the JAX test's, losses rtol 1e-6 and
store and TF gradients atol 1e-5, between each sharded port loss and the
port's one-device loss; against the JAX package's sharded and one-device
losses rtol 1e-5 (the port's one-device loss is ~9e-7 from JAX's, as
tests/test_torch_store_trainer.py bounds it) and the gradients 1e-5.  The
slab store's Adam run converges, and the slab trainer's step moves each
slab as the replicated step moves the store.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from libre_tpu.parallel.mesh import make_mesh as make_mesh_j
from libre_tpu.train import store_trainer as st_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp_grad as swg_t
from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL
from libre_tpu_torch.parallel.mesh import make_mesh
from libre_tpu_torch.train import store_trainer as st_t
from tests.test_store_trainer import make_problem

torch.set_num_threads(1)
CPU = torch.device("cpu")
D_K, D_V = 4, 2


def cpu_mesh(n_brick, n_ray):
    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[CPU] * (n_brick * n_ray))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX one-device, views × rows and slab losses with their store and
    TF gradients (the gradients unpadded), on one set of targets."""
    problem, store, tf = make_problem(n_views=2)
    targets = st_j.render_views(problem, store, tf) * 0.8 + 0.05
    mesh = make_mesh_j(n_brick=D_K, n_ray=D_V)
    dims = (problem.na_real, problem.nc_real, problem.nb_real)
    out = {}
    for name, fn, arg in (
        ("one", st_j.make_loss_fn(problem, None), store),
        # two views: two brick-axis devices
        ("mesh", st_j.make_loss_fn(problem, make_mesh_j(n_brick=2, n_ray=4)), store),
        ("slab", st_j.make_slab_loss_fn(problem, mesh), jax.device_put(
            st_j.shard_store_slabs_uniform(store, D_K), NamedSharding(mesh, P("brick")))),
    ):
        loss, (gs, gtf) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(arg, tf, targets)
        gs = np.asarray(gs).reshape(np.asarray(store).shape)
        out[name] = (float(loss), interop.store_grad_from_jax(gs, dims), np.asarray(gtf))
    return problem, store, tf, np.asarray(targets), out


def port_loss(which, problem, store, tf, targets, mesh):
    """(loss, store gradient, TF gradient) of the port's loss ``which``:
    "slab", "mesh" (views × rows) or "one" (``mesh`` None)."""
    s = torch.from_numpy(np.array(store))
    t = torch.from_numpy(np.array(tf)).requires_grad_()
    targets = np.array(targets)
    if which == "slab":
        leaves = [x.requires_grad_() for x in st_t.shard_store_slabs_uniform(s, mesh.shape["brick"])]
        loss = st_t.make_slab_loss_fn(problem, mesh)(leaves, t, torch.from_numpy(targets))
        loss.backward()
        d_store = torch.cat([x.grad for x in leaves]).numpy()
    else:
        s.requires_grad_()
        loss = st_t.make_loss_fn(problem, mesh)(s, t, torch.from_numpy(targets))
        loss.backward()
        d_store = s.grad.numpy()
    return float(loss.detach()), d_store, t.grad.numpy()


@pytest.mark.parametrize("which,shape", [
    ("mesh", (2, 4)), ("mesh", (2, 2)), ("mesh", (1, 2)), ("mesh", (2, 1)),
    ("slab", (4, 2)), ("slab", (2, 2)), ("slab", (2, 1)), ("slab", (4, 1)),
])
def test_sharded_losses_and_grads_match_jax(jax_side, which, shape):
    """Each port loss at each (brick, ray) mesh shape against the JAX
    sharded loss of its kind (views × rows on 2 × 4, slabs on 4 × 2) and
    the JAX one-device loss."""
    problem_j, store_j, tf_j, targets, want = jax_side
    problem = interop.store_problem_from_jax(problem_j)
    params = interop.params_from_jax({"store": store_j, "tf": tf_j},
                                     (problem.na_real, problem.nc_real, problem.nb_real))
    got = port_loss(which, problem, params["store"], params["tf"], targets, cpu_mesh(*shape))
    one = port_loss("one", problem, params["store"], params["tf"], targets, None)
    # The sharding bound, on one implementation: the JAX test's.
    np.testing.assert_allclose(got[0], one[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], one[1], atol=1e-5)
    np.testing.assert_allclose(got[2], one[2], atol=1e-5)
    # Against the JAX package: its losses differ from the port's one-device
    # loss by ~9e-7 already (tests/test_torch_store_trainer.py holds them to
    # 1e-5); the gradients to the JAX test's 1e-5.
    for ref in (want[which], want["one"]):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
        np.testing.assert_allclose(got[2], ref[2], atol=1e-5)
    assert np.abs(got[1]).max() > 1e-4


def test_slab_mode_render_matches_monolith(jax_side):
    """The 13-float slab mode of ``render_store_grid_diff`` on an extended
    slab renders what the one-device render renders on its planes: the
    fold of the segments of four slabs equals the whole image, and a
    13-float vector needs a slab ``StaticView`` (``k_total``)."""
    problem_j, store_j, tf_j, _targets, _want = jax_side
    problem = interop.store_problem_from_jax(problem_j)
    dims = (problem.na_real, problem.nc_real, problem.nb_real)
    params = interop.params_from_jax({"store": store_j, "tf": tf_j}, dims)
    store, tf = torch.from_numpy(params["store"]), torch.from_numpy(params["tf"])
    zeros = torch.zeros((1,) + problem.inter_size + (4,))
    one = st_t.make_loss_fn(dataclass_views(problem, 1))(store, tf, zeros)
    slabs = st_t.shard_store_slabs_uniform(store, D_K)
    slab = st_t.make_slab_loss_fn(dataclass_views(problem, 1), cpu_mesh(D_K, 1))(slabs, tf, zeros)
    np.testing.assert_allclose(float(slab), float(one), rtol=1e-6)
    static = problem.static_for(problem.inter_size[0])
    with pytest.raises(ValueError, match="view vector"):
        swg_t.render_store_grid_diff(store, tf, torch.zeros(13), static)


def dataclass_views(problem, n):
    import dataclasses

    return dataclasses.replace(problem, views=problem.views[:n])


def test_slab_loss_rejects_what_it_cannot_shard(jax_side):
    """The JAX package's conditions: one march sign, divisible axes, and
    K ≥ Na (one halo slice each side)."""
    import dataclasses

    problem = interop.store_problem_from_jax(jax_side[0])
    mesh = cpu_mesh(D_K, D_V)
    flipped = problem.views.copy()
    flipped[1, 9] = -flipped[1, 9]
    with pytest.raises(ValueError, match="sign"):
        st_t.make_slab_loss_fn(dataclasses.replace(problem, views=flipped), mesh)
    with pytest.raises(ValueError, match="divide"):
        st_t.make_slab_loss_fn(problem, cpu_mesh(3, 1))
    with pytest.raises(ValueError, match="k_planes >= na"):
        st_t.make_slab_loss_fn(dataclasses.replace(problem, k_planes=8), mesh)
    with pytest.raises(ValueError, match="unpadded"):
        st_t.make_slab_loss_fn(dataclasses.replace(problem, na_store=problem.na_real + 1), mesh)
    with pytest.raises(ValueError, match="divide"):
        st_t.make_loss_fn(problem, cpu_mesh(4, 1))
    with pytest.raises(TypeError):
        st_t.make_loss_fn(problem, object())


def test_slab_training_converges_and_steps_as_replicated(jax_side):
    """Adam over the slab-sharded store (``make_slab_train_step``): the
    loss halves in 8 steps; and one SGD step of the slab trainer moves the
    slabs as one step of the replicated trainer moves the store."""
    problem_j, store_j, tf_j, _t, _w = jax_side
    problem = interop.store_problem_from_jax(problem_j)
    dims = (problem.na_real, problem.nc_real, problem.nb_real)
    params = interop.params_from_jax({"store": store_j, "tf": tf_j}, dims)
    store, tf = torch.from_numpy(params["store"]), torch.from_numpy(params["tf"])
    targets = st_t.render_views(problem, store, tf).detach()
    rng = np.random.default_rng(0)
    init = params["store"].copy()
    covered = init > -0.5
    init[covered] = np.clip(init[covered] + rng.normal(0, 0.25, covered.sum()), 0, 1)
    init[:2, :3, :4] = SENTINEL  # a hole no brick covers
    init = torch.from_numpy(init.astype(np.float32))
    mesh = cpu_mesh(D_K, D_V)

    slabs = [s.requires_grad_() for s in st_t.shard_store_slabs_uniform(init, D_K)]
    tf_p = tf.clone().requires_grad_()
    step = st_t.make_slab_train_step(problem, torch.optim.Adam(slabs + [tf_p], lr=5e-2), mesh)
    losses = [float(step({"slabs": slabs, "tf": tf_p}, targets)) for _ in range(8)]
    assert losses[-1] < losses[0] * 0.5, losses
    assert bool((torch.cat(slabs)[:2, :3, :4] == SENTINEL).all())

    sgd = {}
    for kind in ("slab", "replicated"):
        leaf = init.clone().requires_grad_()
        tf_l = tf.clone().requires_grad_()
        if kind == "slab":
            leaves = [s.requires_grad_() for s in st_t.shard_store_slabs_uniform(init, D_K)]
            st_t.make_slab_train_step(problem, torch.optim.SGD(leaves + [tf_l], lr=10.0), mesh)(
                {"slabs": leaves, "tf": tf_l}, targets)
            sgd[kind] = (torch.cat(leaves).detach(), tf_l.detach())
        else:
            st_t.make_train_step(problem, torch.optim.SGD([leaf, tf_l], lr=10.0))(
                {"store": leaf, "tf": tf_l}, targets)
            sgd[kind] = (leaf.detach(), tf_l.detach())
    assert float((sgd["replicated"][0] - init).abs().max()) > 1e-3
    np.testing.assert_allclose(sgd["slab"][0].numpy(), sgd["replicated"][0].numpy(), atol=1e-4)
    np.testing.assert_allclose(sgd["slab"][1].numpy(), sgd["replicated"][1].numpy(), atol=1e-4)


def test_fit_with_mesh_matches_one_device(jax_side):
    """``fit(mesh=…)`` takes the same SGD steps as ``fit`` on one device."""
    problem_j, store_j, tf_j, _t, _w = jax_side
    problem = interop.store_problem_from_jax(problem_j)
    dims = (problem.na_real, problem.nc_real, problem.nb_real)
    params = interop.params_from_jax({"store": store_j, "tf": tf_j}, dims)
    targets = st_t.render_views(problem, torch.from_numpy(params["store"]),
                                torch.from_numpy(params["tf"])).detach()
    init = np.where(params["store"] > -0.5, 0.5, SENTINEL).astype(np.float32)
    runs = [
        st_t.fit(problem, targets, init, params["tf"], device="cpu", mesh=mesh, steps=2,
                 optimizer=lambda p: torch.optim.SGD(p, lr=10.0))
        for mesh in (None, cpu_mesh(2, 2))
    ]
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=1e-6)
    np.testing.assert_allclose(runs[1][0]["store"].detach().numpy(),
                               runs[0][0]["store"].detach().numpy(), atol=1e-5)
