"""Differentiable volume scene (``libre_tpu.models.volume_scene``): a
brick set's densities and the transfer function as trainable leaves,
rendered by the exact marcher with its early exit on.

The reference renders through the XLA marcher ``raycast.render`` and is
differentiated by ``jax.grad``; here :meth:`VolumeScene.render` runs
``exact.render_marcher_diff`` over the scene's bricks in their storage
order, as the reference does (forward K3, ``csrc/exact_march.cu``;
backward K4 over the same set, ``csrc/exact_march_bwd.cu``, which walks
only the samples K3 composited; their plain versions on the CPU), one
march per jittered subpixel sample, averaged, as ``exact.render_exact``
does.  :meth:`VolumeScene.from_volume` makes one brick filling the global
box (``reference.single_brick_set``); the ``parameters`` are
{"density": (N, BZ, BY, BX), "tf": (T, 4)}, as the reference's.

:meth:`VolumeScene.render_sharded` renders over a (ray × brick) mesh
(``parallel.render.render_rays_sharded``: K3 once per shard on its ray
rows and its front-to-back brick chunk, the segments folded in rank
order), differentiable as ``render`` is.
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
from libre_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class VolumeScene:
    """Scene = brick geometry (static) + density/TF parameters (leaves)."""

    bricks: BrickSet  # data field = current density estimate, (N, BZ, BY, BX)
    tf: torch.Tensor  # (T, 4)
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
        return {"density": self.bricks.data, "tf": self.tf}

    def with_parameters(self, params: dict) -> "VolumeScene":
        return dataclasses.replace(
            self,
            bricks=self.bricks._replace(data=params["density"]),
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
        """(H, W, 4) image, bottom-up rows, on the scene's device, the
        bricks marched in their storage order; differentiable in
        ``density`` and ``tf``."""
        with span("libre.scene.render"):
            density = self.bricks.data
            vx, vy, vw, vh = camera.viewport
            images = []
            for s in range(self.params.samples_per_pixel):
                view = exact.exact_view(
                    camera, self.params, self.global_min, self.global_max, bricks=self.bricks,
                    sample_index=s, device=density.device,
                )
                images.append(exact.render_marcher_diff(density, self.tf, view))
            return (sum(images) / float(len(images))).reshape(vh, vw, 4)

    def render_sharded(self, mesh, camera: Camera) -> torch.Tensor:
        """(H, W, 4) image over a (ray, brick) mesh, on the mesh's lead
        device, from the first jittered subpixel sample as the JAX
        package's: the bricks are reordered front to back and padded to
        the brick-axis size (``shard_bricks_front_to_back``), the rays
        split in row blocks over the ray axis; differentiable in
        ``density`` and ``tf``."""
        from libre_tpu_torch.ops import rays as ray_ops
        from libre_tpu_torch.parallel.mesh import BRICK_AXIS, require_mesh
        from libre_tpu_torch.parallel.render import (
            render_rays_sharded,
            shard_bricks_front_to_back,
        )

        require_mesh("VolumeScene.render_sharded", mesh)
        dev = self.bricks.data.device
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport, device=dev
        )
        dirs = dirs.reshape(-1, 3)
        tnp = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
        bricks, _ = shard_bricks_front_to_back(
            self.bricks, eye.cpu().numpy(), mesh.shape[BRICK_AXIS]
        )
        vx, vy, vw, vh = camera.viewport
        out = render_rays_sharded(
            mesh, bricks, self.tf, eye, dirs, tnp, self.params, self.global_min,
            self.global_max, self.max_steps(), width=vw,
        )
        return out.reshape(vh, vw, 4)
