"""Where a training step's gradients live, on the CPU.

``render_store_grid_diff`` over an (N, 11) matrix of views renders N views
of one store in one autograd node whose backward leaves one store and one
TF gradient: the first view's backward sweep zeroes them and the other
N − 1 add into them (``store_grid_backward.accumulated`` counts those).
``train.update.train_step`` releases every leaf's gradient before the
loss, so the buffer a backward wrote becomes the leaf's ``.grad`` with no
copy and no zeroed ``.grad`` to add into, and the optimizer steps the
leaves it stepped when the step zeroed the gradients in place.

The scene: ``test_torch_store_operands``' 16³ store with a SENTINEL hole
and 3 views of 16×12 rays over K = 32 planes, and an 8³ volume seen by one
12×10 exact view.
"""

import numpy as np
import pytest
import torch

from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.ops.exact import exact_view
from libre_tpu_torch.train import init_exact_state, make_exact_train_step, update
from libre_tpu_torch.train import store_trainer as st
from tests.test_torch_profiling import _exact_parts
from tests.test_torch_store_operands import scene


def _views(problem):
    return problem.static_for(problem.inter_size[0]), torch.as_tensor(
        problem.views, dtype=torch.float32)


def _cotangent(n, inter_size):
    return torch.randn((n, *inter_size, 4), generator=torch.Generator().manual_seed(4))


@pytest.mark.parametrize("diff_tf", [True, False])
def test_many_views_equal_the_sum_of_one_view_calls(diff_tf):
    """The N-view render is the N one-view renders stacked, bit for bit,
    and its store and TF gradients their summed gradients within
    round-off (2e-6 of the largest); with ``diff_tf`` off the TF gets
    none."""
    problem, truth, tf0, _targets = scene(diff_tf)
    static, views = _views(problem)
    g = _cotangent(len(views), problem.inter_size)
    runs = []
    for many in (True, False):
        store = torch.where(truth > -0.5, 0.5, swb.SENTINEL).requires_grad_()
        tf = tf0.clone().requires_grad_()
        if many:
            img = swg.render_store_grid_diff(store, tf, views, static)
        else:
            img = torch.stack([swg.render_store_grid_diff(store, tf, vs, static) for vs in views])
        (img * g).sum().backward()
        runs.append((img.detach(), store.grad, tf.grad))
    (img, ds, dtf), (img_one, ds_one, dtf_one) = runs
    assert img.shape == (len(views), *problem.inter_size, 4)
    assert torch.equal(img, img_one)
    assert float(ds_one.abs().max()) > 0.0
    assert float((ds - ds_one).abs().max()) <= 2e-6 * float(ds_one.abs().max())
    if diff_tf:
        assert float((dtf - dtf_one).abs().max()) <= 2e-6 * float(dtf_one.abs().max())
    else:
        assert dtf is None and dtf_one is None


@pytest.mark.parametrize("n_views,backwards", [(1, 1), (2, 1), (3, 1), (3, 2)])
def test_accumulated_counts_n_minus_one_a_backward(n_views, backwards, monkeypatch):
    """Each backward of an N-view render makes one backward sweep into
    fresh buffers and N − 1 into those."""
    problem, truth, tf0, _targets = scene()
    static, views = _views(problem)
    monkeypatch.setattr(swg.store_grid_backward, "accumulated", 0)
    store = truth.clone().requires_grad_()
    tf = tf0.clone().requires_grad_()
    for _ in range(backwards):
        swg.render_store_grid_diff(store, tf, views[:n_views], static).sum().backward()
    assert swg.store_grid_backward.accumulated == backwards * (n_views - 1)


def _store_run():
    """(the store trainer's leaves, one step of it over the scene's 3
    views)."""
    problem, truth, tf0, targets = scene()
    store = torch.where(truth > -0.5, 0.5, swb.SENTINEL).requires_grad_()
    tf = (tf0 * 0.9).requires_grad_()
    step = st.make_train_step(problem, torch.optim.Adam([store, tf], lr=3e-2))
    return [store, tf], lambda: step({"store": store, "tf": tf}, targets)


def _exact_run():
    """(the exact trainer's leaves, one step of it through one view)."""
    camera, params, tf = _exact_parts()
    state = init_exact_state(np.full((8, 8, 8), 0.5, np.float32), tf,
                             lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
    view = exact_view(camera, params, device="cpu")
    step = make_exact_train_step(view)
    target = torch.rand((view.n_rays, 4), generator=torch.Generator().manual_seed(2))
    return [state.params["density"], state.params["tf"]], lambda: step(state, target)


@pytest.mark.parametrize("trainer", [_store_run, _exact_run], ids=["store", "exact"])
def test_grad_is_the_buffer_the_backward_wrote(trainer):
    """After every step each leaf's ``.grad`` is the tensor autograd
    handed the leaf (its data pointer, recorded in a leaf hook): the
    backward's own buffer, not a zeroed ``.grad`` it was added into."""
    leaves, run = trainer()
    handed = [[] for _ in leaves]
    for leaf, seen in zip(leaves, handed):
        leaf.register_hook(lambda g, seen=seen: seen.append(g.data_ptr()))
    for i in range(3):
        run()
        for leaf, seen in zip(leaves, handed):
            assert len(seen) == i + 1
            assert leaf.grad.data_ptr() == seen[-1], i
            assert float(leaf.grad.abs().max()) > 0.0


def _old_train_step(optimizer, compute_loss, *, zero_grads=()):
    """The step as it was: gradients zeroed in place, the loss, backward,
    each ``zero_grads`` leaf given a new zero gradient, the update."""
    optimizer.zero_grad(set_to_none=False)
    loss = compute_loss()
    loss.backward()
    with torch.no_grad():
        for t in zero_grads:
            t.grad = torch.zeros_like(t)
        update.step_optimizer(optimizer)
    return loss.detach()


OPTIMIZERS = {
    "adam": lambda p: torch.optim.Adam(p, lr=1e-2),
    "sgd_momentum": lambda p: torch.optim.SGD(p, lr=1e-2, momentum=0.9),
    "fused_adam": lambda p: torch.optim.Adam(p, lr=1e-2),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_steps_the_leaves_it_stepped_before(name, monkeypatch):
    """Over 5 steps of a loss that reaches leaf a every step, b on the
    first only and c never, with d a ``zero_grads`` leaf, the step moves
    each leaf and keeps each optimizer state as the step that zeroed
    gradients in place did, bit for bit (b and d stepping on zeros, c not
    at all), and d's zero gradient is made once.  "fused_adam" takes
    ``FusedAdam`` (the kernel's plain version on the CPU)."""
    if name == "fused_adam":
        monkeypatch.setattr(update, "on_card", lambda optimizer: True)
    gen = torch.Generator().manual_seed(6)
    start = [torch.randn(5, generator=gen) for _ in range(4)]
    runs = []
    for step in (update.train_step, _old_train_step):
        a, b, c, d = (x.clone().requires_grad_() for x in start)
        opt = OPTIMIZERS[name]([a, b, c, d])
        d_grads = []
        for i in range(5):
            step(opt, lambda: (a * a).sum() + (b.sum() if i == 0 else 0.0), zero_grads=[d])
            d_grads.append(d.grad.data_ptr())
        states = [opt.state.get(x) for x in (a, b, c, d)]
        runs.append(([x.detach() for x in (a, b, c, d)], states, d_grads))
    (got, states, d_grads), (want, states_old, _) = runs
    for x, y, state, state_old in zip(got, want, states, states_old):
        assert torch.equal(x, y)
        assert (state is None) == (state_old is None)
        for key in state or {}:
            assert torch.equal(torch.as_tensor(state[key]), torch.as_tensor(state_old[key])), key
    assert states[2] is None and states[3] is not None  # c never stepped, d on zeros
    assert not torch.equal(got[1], start[1])  # b moves on its first gradient's momentum
    assert len(set(d_grads)) == 1
