"""Differentiable volume scene (``libre_tpu.models.volume_scene``): one
brick's density and the transfer function as trainable leaves, rendered
by the exact marcher with its early exit on.

The reference renders through the XLA marcher ``raycast.render`` and is
differentiated by ``jax.grad``; here :meth:`VolumeScene.render` runs
``exact.render_marcher_diff`` (forward K3, ``csrc/exact_march.cu``;
backward K4, ``csrc/exact_march_bwd.cu``, which walks only the samples
K3 composited; their plain versions on the CPU), one march per jittered
subpixel sample, averaged, as ``exact.render_exact`` does.  The scene is
one brick filling the global box (``reference.single_brick_set``); its
``parameters`` are {"density": (Z, Y, X), "tf": (256, 4)}.  The (ray ×
brick) sharded render is ROADMAP M9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops.reference import (
    BrickSet,
    Camera,
    RenderParams,
    max_steps_for_bricks,
    single_brick_set,
)
from libre_tpu_torch.ops.transfer_function import default_color_map


@dataclasses.dataclass
class VolumeScene:
    """Scene = brick geometry (static) + density/TF parameters (leaves)."""

    bricks: BrickSet  # data field = current density estimate, (1, Z, Y, X)
    tf: torch.Tensor  # (256, 4)
    global_min: np.ndarray
    global_max: np.ndarray
    params: RenderParams

    @classmethod
    def from_volume(
        cls,
        volume_zyx,
        tf: Optional[np.ndarray] = None,
        params: Optional[RenderParams] = None,
        device="cuda",
    ) -> "VolumeScene":
        """The scene of one (Z, Y, X) volume on ``device``, with the
        default colormap and the reference's default params (trilinear,
        data range [0, 1], early exit 0.999) unless given."""
        vol = torch.as_tensor(volume_zyx, dtype=torch.float32).to(device)
        tf = default_color_map() if tf is None else tf
        return cls(
            bricks=single_brick_set(vol),
            tf=torch.as_tensor(tf, dtype=torch.float32).to(device),
            global_min=np.float32([-0.5] * 3),
            global_max=np.float32([0.5] * 3),
            params=params
            or RenderParams(data_source_range=(0.0, 1.0), filter_mode="trilinear"),
        )

    # ------------------------------------------------------------ params
    @property
    def parameters(self) -> dict:
        return {"density": self.bricks.data[0], "tf": self.tf}

    def with_parameters(self, params: dict) -> "VolumeScene":
        return dataclasses.replace(
            self,
            bricks=self.bricks._replace(data=params["density"][None]),
            tf=params["tf"],
        )

    # ------------------------------------------------------------ render
    def max_steps(self) -> int:
        return max_steps_for_bricks(
            self.bricks.world_min.detach().cpu().numpy(),
            self.bricks.world_max.detach().cpu().numpy(),
            self.params.step_size,
        )

    def render(self, camera: Camera) -> torch.Tensor:
        """(H, W, 4) image, bottom-up rows, on the scene's device;
        differentiable in ``density`` and ``tf``."""
        if self.bricks.num_bricks != 1:
            raise NotImplementedError(
                f"VolumeScene.render: {self.bricks.num_bricks} bricks; multi-brick exact "
                f"gradients are out of scope (ROADMAP)"
            )
        density = self.bricks.data[0]
        wmin = self.bricks.world_min[0].detach().cpu().numpy()
        wmax = self.bricks.world_max[0].detach().cpu().numpy()
        vx, vy, vw, vh = camera.viewport
        images = []
        for s in range(self.params.samples_per_pixel):
            view = exact.exact_view(
                camera, self.params, self.global_min, self.global_max,
                world_min=wmin, world_max=wmax, sample_index=s, device=density.device,
            )
            images.append(exact.render_marcher_diff(density, self.tf, view))
        return (sum(images) / float(len(images))).reshape(vh, vw, 4)

    def render_sharded(self, mesh, camera: Camera) -> torch.Tensor:
        """The (ray × brick) mesh-sharded render: ROADMAP M9."""
        raise NotImplementedError("VolumeScene.render_sharded: the sharded render is ROADMAP M9")
