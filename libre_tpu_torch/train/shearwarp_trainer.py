"""Inverse rendering through the plain shear-warp pipeline
(``libre_tpu.train.shearwarp_trainer``), on one device.

BASELINE config 5 at dense-level granularity: optimize a full (Z, Y, X)
density grid and the transfer function against multi-view target slope
images through ``shearwarp.render_slope_grid`` (the plain matrix
pipeline: axis lerps and two-tap resampling as batched products, a
closed-form composite), differentiated by autograd.  Per step: the mean
over views of the mean squared error, ``backward``, a ``torch.optim``
update, then both leaves clamped to [0, 1].

The early exit is off under training (a step function of the parameters);
classification is "pre" or "post" as configured, both differentiable.
Per-view plans (major axis, slope bounds) are host-built constants, like
camera matrices.  With a (ray × brick) ``mesh`` each view renders through
``parallel.shearwarp_sharded.render_slope_grid_sharded`` (rows over the
ray axis, plane ranges over the brick axis); the volume and TF are
replicated by autograd's copies, so their gradients sum onto their own
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops.reference import Camera, RenderParams
from libre_tpu_torch.parallel.mesh import require_mesh
from libre_tpu_torch.parallel.shearwarp_sharded import render_slope_grid_sharded
from libre_tpu_torch.train import update
from libre_tpu_torch.train.update import EARLY_EXIT_OFF
from libre_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ShearWarpProblem:
    """Static problem description: views + render configuration."""

    plans: Tuple[sw.ShearWarpPlan, ...]
    world_min: np.ndarray
    world_max: np.ndarray
    params: RenderParams
    swp: sw.ShearWarpParams

    @classmethod
    def from_cameras(
        cls,
        cameras: Sequence[Camera],
        world_min,
        world_max,
        params: RenderParams,
        swp: sw.ShearWarpParams,
    ) -> "ShearWarpProblem":
        # The early exit is a step function of the parameters and would
        # zero the gradients behind the cut: off under grad.
        params = dataclasses.replace(params, early_exit=EARLY_EXIT_OFF)
        return cls(
            plans=tuple(sw.make_plan(c, swp.slope_margin) for c in cameras),
            world_min=np.asarray(world_min, np.float32),
            world_max=np.asarray(world_max, np.float32),
            params=params,
            swp=swp,
        )

    def render_views(self, mesh, volume, tf) -> List[torch.Tensor]:
        """All views' slope-grid images (V, U, 4): on ``volume``'s device
        with ``mesh`` None, else sharded over the mesh and on its lead
        device; each view under the span ``libre.dense.forward``."""
        if mesh is not None:
            require_mesh("ShearWarpProblem.render_views", mesh)
        outs = []
        for plan in self.plans:
            with span("libre.dense.forward"):
                if mesh is None:
                    img, _, _ = sw.render_slope_grid(
                        volume, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
                        self.world_min, self.world_max, self.params, self.swp,
                    )
                else:
                    img = render_slope_grid_sharded(
                        mesh, volume, tf, plan.eye, plan.axis, plan.sign, plan.bounds,
                        self.world_min, self.world_max, self.params, self.swp,
                    )
            outs.append(img)
        return outs


def make_train_step(problem: ShearWarpProblem, optimizer: torch.optim.Optimizer, mesh=None):
    """step(params, targets) → loss, one optimization step in place.

    ``params`` = {"volume": (Z, Y, X), "tf": (T, 4)}, the two tensors
    ``optimizer`` was built over; ``targets`` one (V, U, 4) image per
    view.  The loss is the mean over views of each view's mean squared
    error, rendered over ``mesh`` if given; after the update both leaves
    are clamped to [0, 1] (their physical ranges)."""
    if mesh is not None:
        require_mesh("make_train_step", mesh)

    def loss_fn(volume, tf, targets):
        imgs = problem.render_views(mesh, volume, tf)
        losses = [torch.mean((img - tgt.to(img.device)) ** 2) for img, tgt in zip(imgs, targets)]
        return sum(losses) / len(losses)

    def step(params, targets):
        volume, tf = params["volume"], params["tf"]
        return update.train_step(optimizer, lambda: loss_fn(volume, tf, targets),
                                 clamp=[volume, tf])

    return step


def fit(
    problem: ShearWarpProblem,
    targets: Sequence,
    init_volume,
    init_tf,
    *,
    device="cuda",
    mesh=None,
    optimizer: Optional[Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]] = None,
    steps: int = 100,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> Tuple[dict, List[float]]:
    """Run the optimization on ``device``; returns (params, losses).

    ``optimizer`` builds a ``torch.optim.Optimizer`` from the parameter
    list [volume, tf] (default ``torch.optim.Adam(lr=3e-2)``, the
    reference's ``optax.adam(3e-2)``).  ``on_step(i, loss)``, if given, is
    called after each step."""
    return update.fit(
        lambda opt: make_train_step(problem, opt, mesh), {"volume": init_volume, "tf": init_tf},
        [torch.as_tensor(t, dtype=torch.float32).to(device) for t in targets], device=device,
        optimizer=optimizer, steps=steps, on_step=on_step,
    )
