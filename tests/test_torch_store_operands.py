"""The store trainer's loss functions build each render's sweep operands
once (``store_trainer._view_operands``), on the CPU.

The scene: a 16³ store with a SENTINEL hole, 3 views of 16×12 rays, K =
32 planes, one march sign.  Each loss function (one device; views × rows
over a 3 × 2 mesh; slabs over a 2 × 2 mesh, of repeated ``cpu`` devices)
trains 3 Adam steps, once as it is and once handing no operands to
``render_store_grid_diff``, so that every render rebuilds its sweep
tables in the forward.  The two runs are equal
bit for bit, and ``shearwarp_bricked.sweep_tables.builds`` counts one
build per render of a call, once, however many steps run.
"""

import numpy as np
import pytest
import torch

from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.ops.transfer_function import default_color_map
from libre_tpu_torch.parallel.mesh import make_mesh
from libre_tpu_torch.testing import smooth_volume
from libre_tpu_torch.train import store_trainer as st

N, K, INTER = 16, 32, (16, 12)
EYES = ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3], [0.05, -0.12, 1.5])
STEPS = 3
# (brick, ray) mesh shape of each sharded loss, and the renders of one call:
# views × ray shards for views × rows, views × shards for slabs.
MESHES = {"one": None, "mesh": (3, 2), "slab": (2, 2)}
RENDERS = {"one": 3, "mesh": 3 * 2, "slab": 3 * 2 * 2}


def scene(diff_tf=True):
    """(problem, truth store, TF, targets)."""
    store = smooth_volume(N, seed=5, device="cpu").permute(sw._PERM[2]).contiguous()
    store[:, :, :3] = swb.SENTINEL
    tf = torch.from_numpy(default_color_map())
    views = np.stack([swg.view_vector(
        world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2, eye=e, sign=-1.0,
        slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=INTER, max_samples_per_ray=K,
    ) for e in EYES])
    problem = st.StoreProblem(
        views=views, na_store=N, na_real=N, nc_real=N, nb_real=N, k_planes=K,
        inter_size=INTER, world_min=np.float32([-0.5] * 3),
        world_max=np.float32([0.5] * 3), axis=2, diff_tf=diff_tf,
    )
    with torch.no_grad():
        targets = st.render_views(problem, store, tf) * 0.8 + 0.05
    return problem, store, tf, targets


def train(which, problem, truth, tf0, targets, steps=STEPS):
    """``steps`` Adam steps of the loss ``which`` from the start of the
    scene (problem, truth, tf0, targets) → per step (loss, store gradient,
    TF gradient, store, TF)."""
    start = torch.where(truth > -0.5, 0.5, swb.SENTINEL)
    tf = (tf0 * 0.9).requires_grad_()
    shape = MESHES[which]
    if which == "slab":
        mesh = make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
        leaves = [s.requires_grad_() for s in st.shard_store_slabs_uniform(start, shape[0])]
        step = st.make_slab_train_step(problem, torch.optim.Adam([*leaves, tf], lr=3e-2), mesh)
        params = {"slabs": leaves, "tf": tf}
    else:
        mesh = None if shape is None else make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
        leaves = [start.clone().requires_grad_()]
        step = st.make_train_step(problem, torch.optim.Adam([leaves[0], tf], lr=3e-2), mesh)
        params = {"store": leaves[0], "tf": tf}
    out = []
    for _ in range(steps):
        loss = step(params, targets)
        out.append([
            loss,
            torch.cat([x.grad for x in leaves]),
            tf.grad.clone(),
            torch.cat([x.detach() for x in leaves]),
            tf.detach().clone(),
        ])
    return out


def rebuilding(monkeypatch):
    """The loss functions as they were before they kept their operands:
    each call makes its view vectors anew and hands no operands to
    ``render_store_grid_diff``, whose forward builds the tables."""
    monkeypatch.setattr(
        st, "_view_operands", lambda static, make_vs: lambda *key: (make_vs(*key), None)
    )


@pytest.mark.parametrize("which,diff_tf", [
    ("one", True), ("one", False), ("mesh", True), ("slab", True),
])
def test_steps_bit_equal_to_rebuilt_tables(which, diff_tf, monkeypatch):
    """Losses, store and TF gradients and the parameters after each step
    equal those of the steps whose renders rebuild their tables."""
    sc = scene(diff_tf)
    monkeypatch.setattr(swb.sweep_tables, "builds", 0)
    got = train(which, *sc)
    assert swb.sweep_tables.builds == RENDERS[which]
    with monkeypatch.context() as m:
        rebuilding(m)
        swb.sweep_tables.builds = 0
        want = train(which, *sc)
        assert swb.sweep_tables.builds == STEPS * RENDERS[which]
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(("loss", "d_store", "d_tf", "store", "tf"), g, w):
            assert torch.equal(a, b), (i, name)
    assert float(got[0][1].abs().max()) > 0.0
    assert not torch.equal(got[-1][3], got[0][3])  # the steps moved the store


@pytest.mark.parametrize("steps", [1, 4])
def test_fit_builds_one_set_a_view(steps, monkeypatch):
    """A fit of any number of steps over Nv views builds Nv sets of tables
    on its device."""
    problem, truth, tf, targets = scene()
    monkeypatch.setattr(swb.sweep_tables, "builds", 0)
    st.fit(problem, targets, torch.where(truth > -0.5, 0.5, swb.SENTINEL), tf,
           device="cpu", steps=steps)
    assert swb.sweep_tables.builds == len(problem.views)


@pytest.mark.parametrize("which", ["mesh", "slab"])
def test_sharded_losses_build_once_a_render(which, monkeypatch):
    """The views × rows loss builds (views × ray shards) sets and the slab
    loss (views × shards), on the first step only."""
    sc = scene()
    monkeypatch.setattr(swb.sweep_tables, "builds", 0)
    train(which, *sc, steps=1)
    assert swb.sweep_tables.builds == RENDERS[which]
    swb.sweep_tables.builds = 0
    train(which, *sc, steps=2)
    assert swb.sweep_tables.builds == RENDERS[which]


def test_operands_are_kept_per_device(monkeypatch):
    """The one-device loss keeps one set per device it is called on: a
    second call on the same device builds nothing, and the forward without
    handed-in operands (targets, probes) builds its own each call."""
    problem, truth, tf, targets = scene()
    loss_fn = st.make_loss_fn(problem)
    monkeypatch.setattr(swb.sweep_tables, "builds", 0)
    with torch.no_grad():
        a = loss_fn(truth, tf, targets)
        b = loss_fn(truth, tf, targets)
        assert swb.sweep_tables.builds == len(problem.views)
        st.render_views(problem, truth, tf)
    assert swb.sweep_tables.builds == 2 * len(problem.views)
    assert torch.equal(a, b)
