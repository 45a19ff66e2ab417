"""Inverse rendering through the differentiable store core
(``libre_tpu.train.store_trainer``), on one device.

Optimizes a normalized density store (and the transfer function) so
that the post-classification renders of a set of views match target
slope grids: per view ``shearwarp_grad.render_store_grid_diff`` (the
sweep kernel forward, the recompute-backward kernel backward), a mean
squared error, a ``torch.optim`` update, then the store clamped to
[0, 1] where covered with uncovered voxels pinned at SENTINEL, and the
TF clamped to [0, 1].

The early exit is off under grad (a step function of the parameters),
and all views share one major axis because the store is assembled in one
axis permutation.  The sharded and slab-sharded trainers are ROADMAP M9.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL

EARLY_EXIT_OFF = 1.1  # 1 − t never exceeds it: no early exit under grad


@dataclasses.dataclass(frozen=True)
class StoreProblem:
    """Static inverse-rendering problem over one store geometry.

    ``views`` is the (Nv, 11) matrix of view vectors
    (``shearwarp_grad.view_vector``, all on the same major axis); the
    static geometry is shared.  ``inter_size`` is the (V, U) slope grid
    per view.
    """

    views: np.ndarray  # (Nv, 11)
    na_store: int
    na_real: int
    nc_real: int
    nb_real: int
    k_planes: int
    inter_size: Tuple[int, int]
    world_min: np.ndarray
    world_max: np.ndarray
    axis: int
    diff_tf: bool = True

    def static_for(self, v_size: int) -> swg.StaticView:
        return swg.static_view(
            na_store=self.na_store,
            na_real=self.na_real,
            nc_real=self.nc_real,
            nb_real=self.nb_real,
            k_planes=self.k_planes,
            v_size=v_size,
            u_size=self.inter_size[1],
            world_min=self.world_min,
            world_max=self.world_max,
            axis=self.axis,
            early_exit=EARLY_EXIT_OFF,
            diff_tf=self.diff_tf,
        )


def render_views(problem: StoreProblem, store, tf) -> torch.Tensor:
    """Render every view → (Nv, V, U, 4) (target generation)."""
    static = problem.static_for(problem.inter_size[0])
    views = torch.as_tensor(problem.views, dtype=torch.float32)
    return torch.stack([
        swg.render_store_grid_diff(store, tf, vs, static) for vs in views
    ])


def make_loss_fn(problem: StoreProblem, mesh=None):
    """(store, tf, targets (Nv, V, U, 4)) → mean-squared error over every
    view, on the store's device."""
    if mesh is not None:
        raise NotImplementedError(
            "make_loss_fn: the views × rows sharded loss is ROADMAP M9"
        )
    v_size, u_size = problem.inter_size
    n_views = len(problem.views)
    static = problem.static_for(v_size)
    views = torch.as_tensor(problem.views, dtype=torch.float32)
    denom = float(n_views * v_size * u_size * 4)

    def loss_fn(store, tf, targets):
        vs = views.to(store.device)
        se = 0.0
        for i in range(n_views):
            img = swg.render_store_grid_diff(store, tf, vs[i], static)
            se = se + torch.sum((img - targets[i]) ** 2)
        return se / denom

    return loss_fn


def make_slab_loss_fn(problem: StoreProblem, mesh):
    """The slab-sharded (model-parallel) loss: ROADMAP M9."""
    raise NotImplementedError(
        "make_slab_loss_fn: the slab-sharded store trainer is ROADMAP M9"
    )


def make_train_step(
    problem: StoreProblem, optimizer: torch.optim.Optimizer, mesh=None
):
    """(params, targets) → loss, one optimization step in place.

    ``params`` = {"store": (Na, Nc, Nb), "tf": (256, 4)}, the two tensors
    ``optimizer`` was built over.  Gradients flow through the sweep
    kernel's forward and the recompute-backward kernel; with
    ``problem.diff_tf`` false the TF gradient is zero.  After the update
    the store is clamped to [0, 1] where it was covered before the update
    and set to SENTINEL elsewhere, and the TF is clamped to [0, 1]."""
    loss_fn = make_loss_fn(problem, mesh)

    def step(params, targets):
        store, tf = params["store"], params["tf"]
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(store, tf, targets)
        loss.backward()
        with torch.no_grad():
            if not problem.diff_tf:
                tf.grad = torch.zeros_like(tf)
            # Coverage is a property of the initial store: taken before
            # the update, so a large step that pushes a covered voxel
            # below the sentinel threshold cannot uncover it for good.
            covered = store > -0.5
            optimizer.step()
            store.copy_(torch.where(covered, store.clamp(0.0, 1.0), SENTINEL))
            tf.clamp_(0.0, 1.0)
        return loss.detach()

    return step


def fit(
    problem: StoreProblem,
    targets,  # (Nv, V, U, 4)
    init_store,
    init_tf,
    *,
    device,
    mesh=None,
    optimizer: Optional[Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]] = None,
    steps: int = 100,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> Tuple[dict, List[float]]:
    """Run the optimization on ``device``; returns (params, losses).

    ``optimizer`` builds a ``torch.optim.Optimizer`` from the parameter
    list [store, tf] (default ``torch.optim.Adam(lr=3e-2)``).
    ``on_step(i, loss)``, if given, is called after each step."""
    if optimizer is None:
        def optimizer(p):
            return torch.optim.Adam(p, lr=3e-2)

    def param(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device).clone().requires_grad_()

    params = {"store": param(init_store), "tf": param(init_tf)}
    step = make_train_step(
        problem, optimizer([params["store"], params["tf"]]), mesh
    )
    targets = torch.as_tensor(targets, dtype=torch.float32).to(device)
    losses = []
    for i in range(steps):
        losses.append(float(step(params, targets)))
        if on_step is not None:
            on_step(i, losses[-1])
    return params, losses
