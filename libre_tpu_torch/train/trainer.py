"""Exact inverse rendering (``libre_tpu.train.trainer``): the mesh-sharded
trainer of a brick set and the single-brick exact trainer.

Mesh-sharded (:class:`InverseRenderProblem`, :func:`init_state`,
:func:`make_train_step`): optimizes ``{"density", "tf"}`` of a
front-to-back sharded brick set against (R, 4) target rays.  The
forward is ``parallel.render.render_rays_sharded`` (sort-first ray rows ×
sort-last brick chunks; per shard the exact march kernel K3 over its
chunk), the backward K4 over each shard's chunk, the fold's and the
moves' autograd carrying the segments' cotangents.  With a mesh the
density is one leaf per brick shard on that shard's device, the port's
counterpart of the JAX package's ``P(BRICK_AXIS)``: each shard owns its
brick range and its gradients; the TF is one leaf on the lead device, its
gradient summed over the shards as ``shard_map``'s transpose sums it.
Early termination is off in training (``early_exit=1.1``), as in the JAX
package: the exact skip rule is a step function of the parameters.

Single-brick form (:func:`init_exact_state`, :func:`make_exact_train_step`):
optimizes ``{"density": (Z, Y, X), "tf": (256, 4)}`` against an (R, 4)
target for one camera's :class:`~libre_tpu_torch.ops.exact.ExactView`
through ``exact.render_exact_diff``.

Each step: the loss (default mean squared error), ``backward``, a
``torch.optim`` update, then the TF clamped to [0, 1]; the density is not
clamped, as in the JAX steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from libre_tpu_torch.ops.exact import ExactView, render_exact_diff
from libre_tpu_torch.ops.reference import BrickSet, RenderParams
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, Mesh, require_mesh
from libre_tpu_torch.parallel.render import render_rays_sharded
from libre_tpu_torch.train.update import leaf, train_step

OptimizerFactory = Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]


def _mse(out, target):
    return torch.mean((out - target) ** 2)


@dataclasses.dataclass
class TrainState:
    """The parameters, the optimizer built over them, and the steps taken.
    ``params["density"]`` is one tensor, or with a mesh a list of one leaf
    per brick shard."""

    params: Dict[str, Any]
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class InverseRenderProblem:
    """What is optimized, as the JAX package's: ``bricks`` the front-to-back
    sharded set (``parallel.render.shard_bricks_front_to_back``) whose
    boxes place the bricks and whose ``data`` is the initial density;
    the global box, the marching ``params`` (the early exit off, 1.1) and
    ``max_steps`` (the longest real brick's march).  ``width`` is the
    screen width K3 and K4 tile each shard's rays by (default: each
    shard's rays in one row), the port's counterpart of the JAX
    package's ``chunk``."""

    bricks: BrickSet
    global_min: Any
    global_max: Any
    params: RenderParams
    max_steps: int
    width: Optional[int] = None

    def render(self, mesh: Mesh, density, tf, eye, dirs, t_near_plane) -> torch.Tensor:
        """(R, 4) on the mesh's lead device, differentiable in ``density``
        (the (N, BZ, BY, BX) stack, or per brick shard its chunk, the
        leaves of :func:`init_state`) and ``tf``."""
        shards = isinstance(density, (list, tuple))
        return render_rays_sharded(
            mesh, self.bricks if shards else self.bricks._replace(data=density), tf, eye,
            dirs, t_near_plane, self.params, self.global_min, self.global_max,
            self.max_steps, width=self.width, brick_data=density if shards else None,
        )


def init_state(
    problem: InverseRenderProblem,
    tf_init,
    optimizer: OptimizerFactory,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """The problem's density and ``tf_init`` as f32 leaves and
    ``optimizer(leaves)`` over them.  Without a mesh the density is one
    (N, BZ, BY, BX) leaf and the TF one leaf, both on the bricks' device.
    With one, brick shard kd's chunk of the density is a leaf on
    ``mesh.device(0, kd)`` and the TF a leaf on ``mesh.lead``."""
    data = problem.bricks.data.detach()
    tf = torch.as_tensor(tf_init, dtype=torch.float32)
    if mesh is None:
        density = leaf(data, data.device)
        tf_leaf = leaf(tf, data.device)
        leaves = [density, tf_leaf]
    else:
        require_mesh("init_state", mesh)
        d_k = mesh.shape[BRICK_AXIS]
        if data.shape[0] % d_k:
            raise ValueError(f"init_state: {data.shape[0]} bricks over {d_k} brick shards")
        b_l = data.shape[0] // d_k
        density = [leaf(data[kd * b_l:(kd + 1) * b_l], mesh.device(0, kd)) for kd in range(d_k)]
        tf_leaf = leaf(tf, mesh.lead)
        leaves = [*density, tf_leaf]
    return TrainState(params={"density": density, "tf": tf_leaf}, optimizer=optimizer(leaves))


def make_train_step(
    problem: InverseRenderProblem,
    optimizer: OptimizerFactory,
    mesh: Mesh,
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """step(state, eye, dirs (R, 3), t_near_plane (R,), target (R, 4)) →
    loss: one optimization step of ``state`` in place over ``mesh``, rays
    split over its ray axis and bricks over its brick axis.  The update is
    the optimizer ``init_state`` built with the same ``optimizer`` factory
    (``state.optimizer``, which holds its moments); ``loss_fn(out,
    target)`` defaults to the mean squared error."""
    del optimizer  # the state holds the optimizer the factory built
    loss_fn = _mse if loss_fn is None else loss_fn
    require_mesh("make_train_step", mesh)

    def step(state: TrainState, eye, dirs, t_near_plane, target) -> torch.Tensor:
        tf = state.params["tf"]

        def compute_loss():
            out = problem.render(mesh, state.params["density"], tf, eye, dirs, t_near_plane)
            return loss_fn(out, target.to(out.device))

        loss = train_step(state.optimizer, compute_loss, clamp=[tf])
        state.step += 1
        return loss

    return step


def init_exact_state(
    density_init,
    tf_init,
    optimizer: OptimizerFactory,
    device="cuda",
) -> TrainState:
    """Copy the initial density and TF to ``device`` as f32 leaves and
    build ``optimizer([density, tf])`` over them."""
    params = {"density": leaf(density_init, device), "tf": leaf(tf_init, device)}
    return TrainState(params=params, optimizer=optimizer([params["density"], params["tf"]]))


def make_exact_train_step(
    view: ExactView,
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """step(state, target (R, 4)) → loss: one optimization step of
    ``state`` in place, through ``view``'s camera.  ``loss_fn(out,
    target)`` defaults to the mean squared error."""
    loss_fn = _mse if loss_fn is None else loss_fn

    def step(state: TrainState, target: torch.Tensor) -> torch.Tensor:
        density, tf = state.params["density"], state.params["tf"]
        loss = train_step(state.optimizer,
                          lambda: loss_fn(render_exact_diff(density, tf, view), target),
                          clamp=[tf])
        state.step += 1
        return loss

    return step
