"""What every trainer shares: the step, its update, its leaves and its loop.

Every trainer's step is :func:`train_step`: the optimizer's gradients
released and the caller's loss under ``libre.train.loss``, ``backward``
under ``libre.train.backward``, and :func:`step_optimizer` under
``libre.train.update``, all of it under ``libre.train.step``.  A leaf's
gradient is the buffer its backward wrote (the store's one K2 buffer,
K4's ``d_volume``): autograd hands a fresh gradient to a leaf that has
none as its ``.grad`` without a copy, so no zeroed ``.grad`` is filled
and added into.

:func:`step_optimizer` names the leaves to pin (the store trainer's
store: clamped to [0, 1] where it was covered before the update, > -0.5,
and set to ``SENTINEL`` elsewhere) and to clamp to [0, 1] (every TF, the
dense trainer's volume).

For a plain ``torch.optim.Adam`` (:func:`plain_adam`) with a leaf on the
card (:func:`on_card`) the step and the epilogues run together in one
pass a leaf of ``ops.adam.adam_update`` (``csrc/adam_update.cu``),
through :class:`FusedAdam`: torch's Adam arithmetic on the given Adam's
own ``param_groups`` (``lr``, ``betas`` and ``eps`` read on every step)
and ``state`` in torch's layout, inside torch's ``Optimizer.step``
profiler range.  The wrapper raises on a leaf it does not take
(not f32, not contiguous, not 16 B aligned); nothing gives way to torch's
step on the card.  Any other optimizer, and a step whose leaves are all
on the CPU, takes ``optimizer.step()`` and the epilogues as separate
passes (:func:`separate_passes`) and adds one to
``step_optimizer.fallbacks``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.optim import optimizer as _optimizer

from libre_tpu_torch.ops.adam import adam_update, apply_epilogue
from libre_tpu_torch.utils.profiling import span

EARLY_EXIT_OFF = 1.1  # 1 − T never exceeds it: no early exit under grad

_OFF = ("amsgrad", "maximize", "capturable", "differentiable", "decoupled_weight_decay")


def plain_adam(optimizer: torch.optim.Optimizer) -> bool:
    """``optimizer`` is a ``torch.optim.Adam`` whose step the kernel
    computes: no AMSGrad, maximize, capturable, differentiable or weight
    decay in any group, ``fused`` not True, ``lr``, ``betas`` and ``eps``
    plain numbers, and no step hooks of its own or global ones."""
    if type(optimizer) is not torch.optim.Adam:
        return False
    if (optimizer._optimizer_step_pre_hooks or optimizer._optimizer_step_post_hooks
            or _optimizer._global_optimizer_pre_hooks
            or _optimizer._global_optimizer_post_hooks):
        return False
    for group in optimizer.param_groups:
        if any(group.get(k) for k in _OFF) or group["weight_decay"] != 0:
            return False
        if group.get("fused") is True:
            return False
        numbers = (group["lr"], *group["betas"], group["eps"])
        if not all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in numbers):
            return False
    return True


def on_card(optimizer: torch.optim.Optimizer) -> bool:
    """Some leaf of ``optimizer`` with a gradient lies on a CUDA device."""
    return any(p.grad is not None and p.is_cuda
               for group in optimizer.param_groups for p in group["params"])


class FusedAdam(torch.optim.Optimizer):
    """The step of a given plain ``torch.optim.Adam`` through
    ``ops.adam.adam_update``.  It shares that Adam's ``param_groups`` and
    ``state``, creates a leaf's state as Adam does (a CPU f32 ``step``,
    ``exp_avg`` and ``exp_avg_sq`` zeros like the leaf), and runs inside
    ``Optimizer.step#FusedAdam.step``, the profiler range torch opens
    around every optimizer's step.  Made anew for each step (~12 us of
    host time), so it always holds the Adam's current state.  A CPU leaf
    beside the card's takes the wrapper's plain version, torch's
    single-tensor Adam op for op; a leaf with an epilogue and no gradient
    (no step) takes the epilogue alone, as after ``optimizer.step()``."""

    def __init__(self, adam: torch.optim.Adam):
        super().__init__([p for g in adam.param_groups for p in g["params"]], adam.defaults)
        self.state, self.param_groups = adam.state, adam.param_groups

    @torch.no_grad()
    def step(self, epilogue: Dict[torch.Tensor, str]) -> None:
        stepped = set()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.tensor(0.0, dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                adam_update(
                    p, p.grad, state["exp_avg"], state["exp_avg_sq"],
                    step=float(state["step"]) + 1, lr=group["lr"], betas=group["betas"],
                    eps=group["eps"], epilogue=epilogue.get(p, "none"),
                )
                state["step"] += 1
                stepped.add(p)
        for t, kind in epilogue.items():
            if t not in stepped:
                apply_epilogue(t, kind)


@torch.no_grad()
def separate_passes(optimizer: torch.optim.Optimizer, pin: Sequence[torch.Tensor] = (),
                    clamp: Sequence[torch.Tensor] = ()) -> None:
    """``optimizer.step()``, then the pin and the clamps, each a pass of
    its own: the update of any optimizer the kernel does not take."""
    # Coverage is a property of the initial store: taken before the update,
    # so a large step that pushes a covered voxel below the sentinel
    # threshold cannot uncover it for good.
    covered = [s > -0.5 for s in pin]
    optimizer.step()
    for s, cov in zip(pin, covered):
        apply_epilogue(s, "pin", cov)
    for t in clamp:
        apply_epilogue(t, "clamp01")


@torch.no_grad()
def step_optimizer(optimizer: torch.optim.Optimizer, *, pin: Sequence[torch.Tensor] = (),
                   clamp: Sequence[torch.Tensor] = ()) -> None:
    """One step of ``optimizer`` in place, then each tensor of ``pin``
    clamped to [0, 1] where it was > -0.5 before the step and set to
    ``SENTINEL`` elsewhere, and each of ``clamp`` clamped to [0, 1]: in
    one kernel pass a leaf for a plain Adam with leaves on the card
    (:func:`plain_adam`, :func:`on_card`), else by
    :func:`separate_passes`."""
    epilogue = {t: "clamp01" for t in clamp}
    epilogue.update({t: "pin" for t in pin})
    if plain_adam(optimizer) and on_card(optimizer):
        FusedAdam(optimizer).step(epilogue)
        return
    step_optimizer.fallbacks += 1
    separate_passes(optimizer, pin, clamp)


step_optimizer.fallbacks = 0


def train_step(optimizer: torch.optim.Optimizer, compute_loss: Callable[[], torch.Tensor], *,
               pin: Sequence[torch.Tensor] = (), clamp: Sequence[torch.Tensor] = (),
               zero_grads: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """One optimization step in place → the detached loss: the gradient
    of every leaf of ``optimizer`` set to None, so that ``backward`` makes
    the buffer it writes the leaf's ``.grad``, and ``compute_loss()``,
    ``backward``, then :func:`step_optimizer` with ``pin`` and ``clamp``,
    inside the spans ``libre.train.step`` / ``.loss`` / ``.backward`` /
    ``.update``.  The optimizer steps the leaves that had a gradient
    before the step or get one from it: a leaf that had one and gets none
    steps on zeros.  Each tensor of ``zero_grads`` (a leaf the loss does
    not differentiate, which the optimizer still steps) is given a zero
    gradient once and keeps it."""
    kept = {id(t) for t in zero_grads}
    with span("libre.train.step"):
        with span("libre.train.loss"):
            had = [p for group in optimizer.param_groups for p in group["params"]
                   if p.grad is not None and id(p) not in kept]
            for p in had:
                p.grad = None
            loss = compute_loss()
        with span("libre.train.backward"):
            loss.backward()
        with span("libre.train.update"), torch.no_grad():
            for t in (*had, *zero_grads):
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            step_optimizer(optimizer, pin=pin, clamp=clamp)
        return loss.detach()


def leaf(x, device) -> torch.Tensor:
    """``x`` as an f32 leaf of its own on ``device``, with a gradient."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).clone().requires_grad_()


def fit(
    make_step: Callable[[torch.optim.Optimizer], Callable],
    inits: Dict[str, object],
    targets,
    *,
    device,
    optimizer: Optional[Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]] = None,
    steps: int,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> Tuple[dict, List[float]]:
    """The trainers' ``fit`` loop → (params, losses): each of ``inits`` a
    :func:`leaf` on ``device`` under its name, ``optimizer`` (default
    ``torch.optim.Adam(lr=3e-2)``) built over them in that order,
    ``make_step(optimizer)`` called ``steps`` times as ``step(params,
    targets)``, and ``on_step(i, loss)``, if given, after each."""
    if optimizer is None:
        def optimizer(p):
            return torch.optim.Adam(p, lr=3e-2)

    params = {name: leaf(x, device) for name, x in inits.items()}
    step = make_step(optimizer(list(params.values())))
    losses = []
    for i in range(steps):
        losses.append(float(step(params, targets)))
        if on_step is not None:
            on_step(i, losses[-1])
    return params, losses
