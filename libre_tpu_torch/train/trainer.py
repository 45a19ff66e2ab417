"""Exact inverse rendering (``libre_tpu.train.trainer``'s exact trainer),
on one device.

Single-brick form: optimizes ``{"density": (Z, Y, X), "tf": (256, 4)}``
against an (R, 4) target for one camera's :class:`~libre_tpu_torch.ops.
exact.ExactView`.  Per step: ``exact.render_exact_diff`` (forward the
exact march kernel K3, backward the recompute-backward kernel K4), the
loss (default mean squared error), ``backward``, a ``torch.optim`` update,
then the TF clamped to [0, 1]; the density is not clamped, as in the JAX
step.  The view's early exit must be off (> 1).

The mesh-sharded ``InverseRenderProblem`` / ``init_state`` /
``make_train_step`` are ROADMAP M9; multi-brick exact gradients are out of
scope.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from libre_tpu_torch.ops.exact import ExactView, render_exact_diff


@dataclasses.dataclass
class TrainState:
    """The parameters, the optimizer built over them, and the steps taken."""

    params: Dict[str, torch.Tensor]  # {"density": (Z, Y, X), "tf": (256, 4)}
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_exact_state(
    density_init,
    tf_init,
    optimizer: Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer],
    device="cuda",
) -> TrainState:
    """Copy the initial density and TF to ``device`` as f32 leaves and
    build ``optimizer([density, tf])`` over them."""

    def param(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device).clone().requires_grad_()

    params = {"density": param(density_init), "tf": param(tf_init)}
    return TrainState(params=params, optimizer=optimizer([params["density"], params["tf"]]))


def make_exact_train_step(
    view: ExactView,
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """step(state, target (R, 4)) → loss: one optimization step of
    ``state`` in place, through ``view``'s camera.  ``loss_fn(out,
    target)`` defaults to the mean squared error."""
    if loss_fn is None:
        def loss_fn(out, target):
            return torch.mean((out - target) ** 2)

    def step(state: TrainState, target: torch.Tensor) -> torch.Tensor:
        density, tf = state.params["density"], state.params["tf"]
        state.optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(render_exact_diff(density, tf, view), target)
        loss.backward()
        with torch.no_grad():
            state.optimizer.step()
            tf.clamp_(0.0, 1.0)
        state.step += 1
        return loss.detach()

    return step
