"""Exact marcher on the card (``libre_tpu.ops.exact_pallas``): the wrapper
of K3 (``csrc/exact_march.cu``) and the single-brick entry points.

:func:`march_exact` marches the rays of one pass through its bricks,
front to back, onto the carried (rgb, a): on a CUDA tensor it launches
the hand-written kernel, on a CPU tensor it runs the plain version
:func:`march_exact_reference` (``ops/raycast.py``, re-exported here), with
the same operands and result.  The engine's ``render`` (the ``xla`` and
``pallas-exact`` renderers) and :func:`render_exact_rays` /
:func:`render_exact` (BASELINE configs 1-2) call it.

Of the JAX package's planning (``plan_exact``) only what fixes the sample
grid and the per-brick box is kept: ``raycast.ray_pack`` and
``raycast.brick_boxes``.  Its slab bucketing, tiers, c-window bounds and
the XLA fallback for oblique rays exist because the TPU has no
arbitrary gather; one thread per ray serves every direction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.raycast import (
    BOX_FLOATS,
    PACK_ROWS,
    brick_boxes,
    march_exact_reference,
    ray_pack,
)
from libre_tpu_torch.ops.reference import (
    Camera,
    RenderParams,
    max_steps_for_bricks,
)
from libre_tpu_torch.ops.transfer_function import TF_SIZE

__all__ = [
    "ATLAS_DTYPES", "march_exact", "march_exact_reference", "render_exact",
    "render_exact_rays",
]

# Atlas dtypes the kernel reads in place, by its dtype code.
ATLAS_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}


def _check_operands(atlas, slots, boxes, tf, rays, carry, samples, used):
    """Reject what K3 does not take before a pointer reaches it."""
    n_bricks, n_rays = slots.shape[0], carry.shape[0]
    expect = {
        "slots": (slots, torch.int32, (n_bricks,)),
        "boxes": (boxes, torch.float32, (n_bricks, BOX_FLOATS)),
        "tf": (tf, torch.float32, (TF_SIZE, 4)),
        "rays": (rays, torch.float32, (len(PACK_ROWS), n_rays)),
        "carry": (carry, torch.float32, (n_rays, 4)),
    }
    if samples is not None:
        expect["samples"] = (samples, torch.int32, (n_rays,))
    if used is not None:
        expect["used"] = (used, torch.int32, (n_bricks,))
    for name, (x, dtype, shape) in expect.items():
        if x.device != atlas.device:
            raise ValueError(f"march_exact: {name} on {x.device}, atlas on {atlas.device}")
        if x.dtype != dtype:
            raise TypeError(f"march_exact: {name} is {x.dtype}, needs {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"march_exact: {name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"march_exact: {name} must be contiguous")
    if atlas.dim() != 4 or not atlas.is_contiguous():
        raise ValueError(f"march_exact: atlas must be a contiguous (n_slots, BZ, BY, BX), got {tuple(atlas.shape)}")


def march_exact(
    atlas: torch.Tensor,
    slots: torch.Tensor,
    boxes: torch.Tensor,
    tf: torch.Tensor,
    rays: torch.Tensor,
    carry: torch.Tensor,
    eye,
    params: RenderParams,
    *,
    max_steps: int,
    width: Optional[int] = None,
    samples: Optional[torch.Tensor] = None,
    used: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One pass of the exact march → the (R, 4) carry after it.

    Operands and result as :func:`march_exact_reference`.  On a CUDA
    tensor this launches ``csrc/exact_march.cu`` on the current stream
    (``march_exact.launches`` counts the launches); ``width`` is the
    screen width the kernel tiles the rays by (16×8 rays per block;
    default: all rays in one row).  On a CPU tensor it runs the plain
    version; on any other device it raises.
    """
    _check_operands(atlas, slots, boxes, tf, rays, carry, samples, used)
    if params.filter_mode not in ("nearest", "trilinear"):
        raise ValueError(f"march_exact: unknown filter mode {params.filter_mode!r}")
    if atlas.device.type == "cpu":
        return march_exact_reference(
            atlas, slots, boxes, tf, rays, carry, eye, params,
            max_steps=max_steps, samples=samples, used=used,
        )
    if atlas.device.type != "cuda":
        raise ValueError(f"march_exact: no kernel for device {atlas.device}")
    if atlas.dtype not in ATLAS_DTYPES:
        raise TypeError(
            f"march_exact: the kernel reads {sorted(map(str, ATLAS_DTYPES))} atlases, "
            f"not {atlas.dtype}"
        )
    for name, x in (("boxes", boxes), ("tf", tf), ("carry", carry)):
        if x.data_ptr() % 16:
            raise ValueError(f"march_exact: {name} must be 16-byte aligned")
    n_rays = carry.shape[0]
    out = torch.empty_like(carry)
    if n_rays == 0:
        return out
    lo, hi = params.data_source_range
    bz, by, bx = atlas.shape[1:]
    ex, ey, ez = (float(v) for v in eye)
    with torch.cuda.device(atlas.device):
        _kernels.launch(
            "exact_march",
            atlas, slots, boxes, tf, rays, carry, out, samples, used,
            ATLAS_DTYPES[atlas.dtype], int(params.filter_mode == "trilinear"),
            slots.shape[0], n_rays, int(width or n_rays), bx, by, bz,
            int(max_steps), ex, ey, ez, params.step_size, 1.0 / (hi - lo),
            -lo / (hi - lo), params.alpha_correction, params.early_exit,
        )
    march_exact.launches += 1
    return out


march_exact.launches = 0


def render_exact_rays(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    *,
    world_min=(-0.5, -0.5, -0.5),
    world_max=(0.5, 0.5, 0.5),
    global_min=None,
    global_max=None,
    clip_planes: Optional[np.ndarray] = None,
    sample_index: int = 0,
    init_carry: Optional[torch.Tensor] = None,  # (R, 4)
) -> torch.Tensor:
    """March every ray of ``camera`` (jittered subpixel sample
    ``sample_index``) through one (Z, Y, X) brick, no ghost voxels, that
    fills its world box → (R, 4) rgba, on the device of ``volume_zyx``.

    ``global_min/max`` default to the brick box (single-brick case); for a
    multi-brick march pass the global volume box so the sample grid is
    shared across bricks (fragRaycast.glsl:152-158), and the earlier
    bricks' carry as ``init_carry``."""
    dev = volume_zyx.device
    gmin = world_min if global_min is None else global_min
    gmax = world_max if global_max is None else global_max
    eye, dirs, cos_z, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport,
        sample_index=sample_index, device=dev,
    )
    dirs = dirs.reshape(-1, 3)
    tnp_ = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
    pack = ray_pack(eye, dirs, tnp_, params.step_size, gmin, gmax, clip_planes)
    boxes = brick_boxes(world_min, world_max, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)).to(dev)
    carry = (
        torch.zeros((dirs.shape[0], 4), device=dev)
        if init_carry is None
        else init_carry.to(device=dev, dtype=torch.float32).contiguous()
    )
    return march_exact(
        volume_zyx[None].contiguous(), torch.zeros(1, dtype=torch.int32, device=dev),
        boxes, tf.to(dev).contiguous(), pack, carry,
        np.asarray(camera.inv_mv, np.float32)[:3, 3], params,
        max_steps=max_steps_for_bricks(
            np.asarray(world_min, np.float32), np.asarray(world_max, np.float32),
            params.step_size,
        ),
        width=camera.viewport[2],
    )


def render_exact(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    global_min=(-0.5, -0.5, -0.5),
    global_max=(0.5, 0.5, 0.5),
    clip_planes: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Single-brick exact render → (H, W, 4), bottom-up rows (configs 1-2):
    the volume fills the global box; one march per jittered subpixel
    sample (fragRaycast.glsl:121-127), averaged."""
    vx, vy, vw, vh = camera.viewport
    imgs = [
        render_exact_rays(
            volume_zyx, tf, camera, params, world_min=global_min,
            world_max=global_max, clip_planes=clip_planes, sample_index=s,
        )
        for s in range(params.samples_per_pixel)
    ]
    return (sum(imgs) / float(len(imgs))).reshape(vh, vw, 4)
