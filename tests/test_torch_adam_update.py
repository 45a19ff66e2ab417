"""The trainers' update (``train/update.py``) and the Adam kernel's plain
version (``ops/adam.py``), on the CPU.

Which path a step takes depends only on what the kernel cannot compute:
a plain ``torch.optim.Adam`` (``plain_adam``) with leaves on the card
(``on_card``) takes the kernel, whose wrapper raises on a leaf it does
not take; any other optimizer, and CPU leaves, ``optimizer.step()`` and
the epilogues as separate passes.  On the CPU every trainer takes the
second path; ``FusedAdam`` over CPU leaves runs the kernel's plain
version, which must be bit for bit ``torch.optim.Adam`` followed by the
old epilogue.  The kernel itself is held to the same on the card
(``tests/test_torch_cuda.py``).
"""

import copy
import types

import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from libre_tpu_torch.ops.adam import EPILOGUES, adam_update
from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL
from libre_tpu_torch.parallel.mesh import make_mesh
from libre_tpu_torch.train import shearwarp_trainer, store_trainer, trainer
from libre_tpu_torch.train.update import (
    FusedAdam,
    on_card,
    plain_adam,
    separate_passes,
    step_optimizer,
)


def _leaves():
    return [torch.rand(8, requires_grad=True), torch.rand(4, 4, requires_grad=True)]


def _with_step_hook(ps):
    opt = torch.optim.Adam(ps)
    opt.register_step_pre_hook(lambda *_: None)
    return opt


# (case, optimizer factory, whether plain_adam accepts it)
OPTIMIZERS = [
    ("adam", lambda ps: torch.optim.Adam(ps, lr=1e-2), True),
    ("adam_foreach", lambda ps: torch.optim.Adam(ps, lr=1e-2, foreach=True), True),
    ("adam_for_loop", lambda ps: torch.optim.Adam(ps, lr=1e-2, foreach=False), True),
    ("amsgrad", lambda ps: torch.optim.Adam(ps, amsgrad=True), False),
    ("weight_decay", lambda ps: torch.optim.Adam(ps, weight_decay=1e-4), False),
    ("maximize", lambda ps: torch.optim.Adam(ps, maximize=True), False),
    ("capturable", lambda ps: torch.optim.Adam(ps, capturable=True), False),
    ("differentiable", lambda ps: torch.optim.Adam(ps, differentiable=True), False),
    ("fused", lambda ps: torch.optim.Adam(ps, fused=True), False),
    ("tensor_lr", lambda ps: torch.optim.Adam(ps, lr=torch.tensor(1e-2), foreach=False), False),
    ("step_hook", _with_step_hook, False),
    ("adamw", lambda ps: torch.optim.AdamW(ps), False),
    ("sgd", lambda ps: torch.optim.SGD(ps, lr=1e-2), False),
]


@pytest.mark.parametrize("case, make, plain", OPTIMIZERS, ids=[c[0] for c in OPTIMIZERS])
def test_selection_predicate(case, make, plain):
    """``plain_adam`` accepts the plain Adam in each ``foreach`` setting
    and nothing else, and CPU leaves are not ``on_card``: a plain Adam
    over CPU leaves falls back to ``optimizer.step()``."""
    leaves = _leaves()
    opt = make(leaves)
    assert plain_adam(opt) is plain, case
    for p in leaves:
        p.grad = torch.randn_like(p)
    assert not on_card(opt)
    if plain:
        before = step_optimizer.fallbacks
        step_optimizer(opt, clamp=[leaves[1]])
        assert step_optimizer.fallbacks == before + 1
        t = leaves[1].detach()
        assert float(t.min()) >= 0.0 and float(t.max()) <= 1.0


def test_global_step_hook_falls_back():
    opt = torch.optim.Adam(_leaves())
    handle = register_optimizer_step_post_hook(lambda *_: None)
    try:
        assert not plain_adam(opt)
    finally:
        handle.remove()
    assert plain_adam(opt)


def _start(n=1001, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = torch.rand(n, generator=gen) * 1.2 - 0.1
    p[:97] = SENTINEL  # uncovered voxels
    p[97] = 0.01  # covered; the first step's large gradient drives it below -0.5
    tf = torch.rand(64, 4, generator=gen)
    return p, tf, gen


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("foreach", [None, True])
def test_plain_version_matches_torch(epilogue, foreach):
    """Five steps of ``FusedAdam`` (the kernel's plain version on CPU
    leaves) bit-equal to ``torch.optim.Adam`` followed by the old
    epilogue, the TF clamped beside it; the pinned voxel that a step
    drives below -0.5 stays covered (clamped to 0, not SENTINEL)."""
    p0, tf0, gen = _start()
    a, ta = p0.clone().requires_grad_(), tf0.clone().requires_grad_()
    b, tb = p0.clone().requires_grad_(), tf0.clone().requires_grad_()
    opt_a = torch.optim.Adam([a, ta], lr=0.8, foreach=foreach)
    opt_b = torch.optim.Adam([b, tb], lr=0.8, foreach=foreach)
    for k in range(5):
        g, gt = torch.randn(p0.shape, generator=gen), torch.randn(tf0.shape, generator=gen)
        if k == 0:
            g[97] = 1e3
        a.grad, b.grad, ta.grad, tb.grad = g.clone(), g.clone(), gt.clone(), gt.clone()
        separate_passes(opt_a, [a] if epilogue == "pin" else [],
                    [ta] + ([a] if epilogue == "clamp01" else []))
        FusedAdam(opt_b).step({b: epilogue, tb: "clamp01"})
        assert torch.equal(a, b) and torch.equal(ta, tb), (k, epilogue)
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_a.state[a][key], opt_b.state[b][key])
    b = b.detach()
    if epilogue == "pin":
        assert float(b[97]) == 0.0 and bool((b[:97] == SENTINEL).all())
    if epilogue == "none":
        assert float(b.min()) < -0.5 or float(b.max()) > 1.0


def test_epilogue_without_a_gradient():
    """A leaf with an epilogue and no gradient takes no step and its
    epilogue alone, as after ``optimizer.step()``."""
    p0, tf0, gen = _start(seed=2)
    tf0 = tf0 * 3.0 - 1.0
    a, ta = p0.clone().requires_grad_(), tf0.clone().requires_grad_()
    b, tb = p0.clone().requires_grad_(), tf0.clone().requires_grad_()
    opt_a, opt_b = torch.optim.Adam([a, ta], lr=0.1), torch.optim.Adam([b, tb], lr=0.1)
    g = torch.randn(p0.shape, generator=gen)
    a.grad, b.grad = g.clone(), g.clone()
    separate_passes(opt_a, [a], [ta])
    FusedAdam(opt_b).step({b: "pin", tb: "clamp01"})
    assert torch.equal(a, b) and torch.equal(ta, tb)
    assert tb not in opt_b.state and float(tb.min()) == 0.0 and float(tb.max()) == 1.0


def test_state_layout_clear_and_lr():
    """The state is torch's: a 0-d CPU f32 ``step``, ``exp_avg`` and
    ``exp_avg_sq`` f32 like the leaf; after step 1 ``exp_avg`` is
    0.1·g; an ``lr`` edited between steps is read; after
    ``state.clear()`` the steps match a fresh optimizer's."""
    p0, tf0, gen = _start(seed=1)
    b = p0.clone().requires_grad_()
    opt = torch.optim.Adam([b], lr=3e-2)
    g = torch.randn(p0.shape, generator=gen)
    b.grad = g.clone()
    FusedAdam(opt).step({b: "pin"})
    state = opt.state[b]
    assert set(state) == {"step", "exp_avg", "exp_avg_sq"}
    step = state["step"]
    assert step.dtype == torch.float32 and step.device.type == "cpu" and step.dim() == 0
    assert float(step) == 1.0
    for key in ("exp_avg", "exp_avg_sq"):
        assert state[key].dtype == torch.float32 and state[key].shape == b.shape
        assert state[key].device == b.device
    assert torch.equal(state["exp_avg"], 0.1 * g)

    # An lr edited between steps, against torch's Adam given the same edit.
    a = b.detach().clone().requires_grad_()
    ref = torch.optim.Adam([a], lr=3e-2)
    ref.load_state_dict(copy.deepcopy(opt.state_dict()))
    for lr in (1e-1, 5e-3):
        opt.param_groups[0]["lr"] = ref.param_groups[0]["lr"] = lr
        g = torch.randn(p0.shape, generator=gen)
        a.grad, b.grad = g.clone(), g.clone()
        separate_passes(ref, [a], [])
        FusedAdam(opt).step({b: "pin"})
        assert torch.equal(a, b)

    # state.clear() restarts: the next steps are a fresh optimizer's.
    opt.state.clear()
    c = b.detach().clone().requires_grad_()
    fresh = torch.optim.Adam([c], lr=5e-3)
    for _ in range(3):
        g = torch.randn(p0.shape, generator=gen)
        b.grad, c.grad = g.clone(), g.clone()
        FusedAdam(opt).step({b: "pin"})
        separate_passes(fresh, [c], [])
        assert torch.equal(b, c)
    assert float(opt.state[b]["step"]) == 3.0


def test_wrapper_checks():
    p, g, m, v = (torch.zeros(8) for _ in range(4))
    with pytest.raises(ValueError, match="epilogue"):
        adam_update(p, g, m, v, step=1, lr=1e-2, betas=(0.9, 0.999), eps=1e-8, epilogue="x")
    with pytest.raises(ValueError, match="float32"):
        adam_update(p, g.double(), m, v, step=1, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    with pytest.raises(ValueError, match="contiguous"):
        adam_update(torch.zeros(8, 2)[:, 0], g, m, v, step=1, lr=1e-2, betas=(0.9, 0.999),
                    eps=1e-8)
    with pytest.raises(ValueError, match="shapes"):
        adam_update(p, torch.zeros(9), m, v, step=1, lr=1e-2, betas=(0.9, 0.999), eps=1e-8)


def _counting(opt):
    """Count the optimizer's own ``step()`` calls."""
    calls = []
    step = opt.step

    def counted(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    opt.step = counted
    return calls


def _store_step(opt, store, tf):
    problem = types.SimpleNamespace(diff_tf=True)
    return store_trainer._update(
        problem, opt, lambda: (store**2).sum() + (tf**2).sum(), [store], tf)


def _exact_step(opt, density, tf, monkeypatch):
    monkeypatch.setattr(trainer, "render_exact_diff",
                        lambda d, t, view: (d.sum() + t.sum()).expand(4, 4))
    state = trainer.TrainState(params={"density": density, "tf": tf}, optimizer=opt)
    return trainer.make_exact_train_step(view=None)(state, torch.zeros(4, 4))


def _mesh_step(opt, density, tf, monkeypatch):
    problem = types.SimpleNamespace(
        render=lambda mesh, d, t, eye, dirs, tnp: (d.sum() + t.sum()).expand(4, 4))
    state = trainer.TrainState(params={"density": density, "tf": tf}, optimizer=opt)
    mesh = make_mesh(n_brick=1, n_ray=1, devices=[torch.device("cpu")])
    step = trainer.make_train_step(problem, lambda ps: opt, mesh)
    return step(state, None, None, None, torch.zeros(4, 4))


def _dense_step(opt, volume, tf, monkeypatch):
    problem = types.SimpleNamespace(
        render_views=lambda mesh, v, t: [(v.sum() + t.sum()).expand(2, 2, 4)])
    step = shearwarp_trainer.make_train_step(problem, opt)
    return step({"volume": volume, "tf": tf}, [torch.zeros(2, 2, 4)])


@pytest.mark.parametrize("name, run", [("store", lambda o, p, t, mp: _store_step(o, p, t)),
                                       ("exact", _exact_step), ("mesh", _mesh_step),
                                       ("dense", _dense_step)])
def test_cpu_trainer_steps_call_optimizer_step(name, run, monkeypatch):
    """On CPU leaves each trainer's step still calls ``optimizer.step()``
    once and never the kernel's wrapper, and its epilogues still apply."""
    p = (torch.rand(6, 5) * 3.0 - 1.0).requires_grad_()
    tf = (torch.rand(8, 4) * 3.0 - 1.0).requires_grad_()
    opt = torch.optim.Adam([p, tf], lr=1e-2)
    calls = _counting(opt)
    launches, fallbacks = adam_update.launches, step_optimizer.fallbacks
    run(opt, p, tf, monkeypatch)
    assert len(calls) == 1, name
    assert adam_update.launches == launches
    assert step_optimizer.fallbacks == fallbacks + 1
    tf = tf.detach()
    assert float(tf.min()) >= 0.0 and float(tf.max()) <= 1.0
