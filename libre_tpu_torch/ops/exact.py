"""Exact marcher on the card (``libre_tpu.ops.exact_pallas``): the wrappers
of K3 (``csrc/exact_march.cu``) and K4 (``csrc/exact_march_bwd.cu``) and
the single-brick entry points.

:func:`march_exact` marches the rays of one pass through its bricks,
front to back, onto the carried (rgb, a): on a CUDA tensor it launches
the hand-written kernel, on a CPU tensor it runs the plain version
:func:`march_exact_reference` (``ops/raycast.py``, re-exported here), with
the same operands and result.  The engine's ``render`` (the ``xla`` and
``pallas-exact`` renderers) and :func:`render_exact_rays` /
:func:`render_exact` (BASELINE configs 1-2) call it.

:func:`render_exact_diff` is the differentiable single-brick render of
one :class:`ExactView`: forward K3, backward :func:`march_exact_backward`
(K4 on a CUDA tensor, ``march_exact_backward_reference`` on a CPU one),
with the early exit off (the exact trainer's semantics).

Of the JAX package's planning (``plan_exact``) only what fixes the sample
grid and the per-brick box is kept: ``raycast.ray_pack`` and
``raycast.brick_boxes``.  Its slab bucketing, tiers, c-window bounds and
the XLA fallback for oblique rays exist because the TPU has no
arbitrary gather; one thread per ray serves every direction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.raycast import (
    BOX_FLOATS,
    PACK_ROWS,
    brick_boxes,
    march_exact_backward_reference,
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
    "ATLAS_DTYPES", "ExactView", "RenderExactDiff", "exact_view", "march_exact",
    "march_exact_backward", "march_exact_backward_reference",
    "march_exact_reference", "render_exact", "render_exact_diff",
    "render_exact_rays",
]

# Atlas dtypes the kernel reads in place, by its dtype code.
ATLAS_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}


def _check_operands(who, atlas, slots, boxes, tf, rays, params, per_ray, samples=None,
                    used=None):
    """Reject what the kernels do not take before a pointer reaches them.
    ``slots`` None means one brick (the backward's).  ``per_ray`` names the
    (R, 4) f32 operands (the carry, or the backward's forward output and
    cotangent)."""
    n_bricks = 1 if slots is None else slots.shape[0]
    n_rays = next(iter(per_ray.values())).shape[0]
    expect = {
        "boxes": (boxes, torch.float32, (n_bricks, BOX_FLOATS)),
        "tf": (tf, torch.float32, (TF_SIZE, 4)),
        "rays": (rays, torch.float32, (len(PACK_ROWS), n_rays)),
    }
    if slots is not None:
        expect["slots"] = (slots, torch.int32, (n_bricks,))
    for name, x in per_ray.items():
        expect[name] = (x, torch.float32, (n_rays, 4))
    if samples is not None:
        expect["samples"] = (samples, torch.int32, (n_rays,))
    if used is not None:
        expect["used"] = (used, torch.int32, (n_bricks,))
    for name, (x, dtype, shape) in expect.items():
        if x.device != atlas.device:
            raise ValueError(f"{who}: {name} on {x.device}, atlas on {atlas.device}")
        if x.dtype != dtype:
            raise TypeError(f"{who}: {name} is {x.dtype}, needs {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{who}: {name} shape {tuple(x.shape)} != {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if atlas.dim() != 4 or not atlas.is_contiguous():
        raise ValueError(f"{who}: atlas must be a contiguous (n_slots, BZ, BY, BX), got {tuple(atlas.shape)}")
    if params.filter_mode not in ("nearest", "trilinear"):
        raise ValueError(f"{who}: unknown filter mode {params.filter_mode!r}")


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
    _check_operands("march_exact", atlas, slots, boxes, tf, rays, params, {"carry": carry},
                    samples, used)
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


def march_exact_backward(
    volume_zyx: torch.Tensor,
    tf: torch.Tensor,
    view: "ExactView",
    out: torch.Tensor,
    g: torch.Tensor,
    *,
    diff_tf: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute backward of :func:`render_exact_diff`'s forward, early
    exit off → (d_volume (Z, Y, X), d_tf (256, 4)).

    Operands and result as :func:`march_exact_backward_reference`: the
    (Z, Y, X) f32 volume filling ``view``'s box, the TF, the forward's
    output ``out`` (marched from a zero carry) and its cotangent ``g``;
    with ``diff_tf`` false the TF gradient is not accumulated and
    ``d_tf`` comes back zero.
    On a CUDA tensor this zeroes the gradients and launches
    ``csrc/exact_march_bwd.cu`` on the current stream, in tiles of
    ``view.width`` rays per row (``march_exact_backward.launches`` counts
    the launches); on a CPU tensor it runs the plain version; on any other
    device it raises."""
    who = "march_exact_backward"
    if volume_zyx.dtype != torch.float32:
        raise TypeError(f"{who}: the volume is {volume_zyx.dtype}, needs float32")
    if volume_zyx.dim() != 3:
        raise ValueError(f"{who}: needs a (Z, Y, X) volume, got {tuple(volume_zyx.shape)}")
    boxes, rays, params = view.brick_boxes, view.ray_pack, view.params
    _check_operands(who, volume_zyx[None], None, boxes, tf, rays, params, {"out": out, "g": g})
    _require_no_early_exit(who, params)
    if volume_zyx.device.type == "cpu":
        return march_exact_backward_reference(volume_zyx, tf, view, out, g, diff_tf=diff_tf)
    if volume_zyx.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {volume_zyx.device}")
    for name, x in (("boxes", boxes), ("tf", tf), ("out", out), ("g", g)):
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")
    d_volume = torch.zeros_like(volume_zyx)
    d_tf = torch.zeros_like(tf)
    n_rays = out.shape[0]
    if n_rays == 0:
        return d_volume, d_tf
    lo, hi = params.data_source_range
    bz, by, bx = volume_zyx.shape
    ex, ey, ez = (float(v) for v in view.eye)
    with torch.cuda.device(volume_zyx.device):
        _kernels.launch(
            "exact_march_bwd",
            volume_zyx, boxes, tf, rays, out, g, d_volume, d_tf,
            int(params.filter_mode == "trilinear"), int(diff_tf), n_rays, int(view.width),
            bx, by, bz, int(view.max_steps), ex, ey, ez, params.step_size,
            1.0 / (hi - lo), -lo / (hi - lo), params.alpha_correction,
        )
    march_exact_backward.launches += 1
    return d_volume, d_tf


march_exact_backward.launches = 0


def _require_no_early_exit(who, params: RenderParams):
    if float(params.early_exit) <= 1.0:
        raise ValueError(
            f"{who} requires early_exit > 1 (disabled): the composite inversion "
            f"needs every sample composited"
        )


@dataclasses.dataclass(frozen=True)
class ExactView:
    """What fixes one camera's sample grid over one brick, computed once
    (the part of the JAX package's ``ExactPlan`` a per-ray kernel needs):
    the (8, R) ``ray_pack``, the (1, 16) ``brick_boxes``, the ``eye``, the
    march length ``max_steps``, the screen ``width`` the kernels tile the
    rays by, and the marching ``params``."""

    ray_pack: torch.Tensor
    brick_boxes: torch.Tensor
    eye: np.ndarray
    max_steps: int
    width: int
    params: RenderParams

    @property
    def n_rays(self) -> int:
        return self.ray_pack.shape[1]


def exact_view(
    camera: Camera,
    params: RenderParams,
    global_min=(-0.5, -0.5, -0.5),
    global_max=(0.5, 0.5, 0.5),
    *,
    world_min=None,
    world_max=None,
    clip_planes: Optional[np.ndarray] = None,
    sample_index: int = 0,
    device="cuda",
) -> ExactView:
    """The :class:`ExactView` of ``camera``'s rays (jittered subpixel
    sample ``sample_index``) over one brick, no ghost voxels, on
    ``device``.  The brick fills ``world_min/max`` (default: the global
    box, the single-brick form); the sample grid is the global box's
    (fragRaycast.glsl:152-158)."""
    wmin = global_min if world_min is None else world_min
    wmax = global_max if world_max is None else world_max
    eye, dirs, cos_z, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport,
        sample_index=sample_index, device=device,
    )
    tnp_ = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
    return ExactView(
        ray_pack=ray_pack(
            eye, dirs.reshape(-1, 3), tnp_, params.step_size, global_min, global_max,
            clip_planes,
        ),
        brick_boxes=brick_boxes(wmin, wmax, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)).to(device),
        eye=np.asarray(camera.inv_mv, np.float32)[:3, 3],
        max_steps=max_steps_for_bricks(
            np.asarray(wmin, np.float32), np.asarray(wmax, np.float32), params.step_size
        ),
        width=camera.viewport[2],
        params=params,
    )


def _march_view(volume_zyx, tf, view: ExactView, carry) -> torch.Tensor:
    slot = torch.zeros(1, dtype=torch.int32, device=volume_zyx.device)
    return march_exact(
        volume_zyx[None].contiguous(), slot, view.brick_boxes,
        tf, view.ray_pack, carry, view.eye, view.params,
        max_steps=view.max_steps, width=view.width,
    )


class RenderExactDiff(torch.autograd.Function):
    """Forward: K3 from a zero carry; backward: K4 (or their plain
    versions on the CPU), accumulating the TF gradient only when the TF
    needs one.  Saves (volume, tf, out), as the JAX package's
    ``_red_fwd``."""

    @staticmethod
    def forward(ctx, volume_zyx, tf, view: ExactView):
        volume_zyx, tf = volume_zyx.contiguous(), tf.contiguous()
        out = _march_view(
            volume_zyx, tf, view, torch.zeros((view.n_rays, 4), device=volume_zyx.device)
        )
        ctx.view = view
        ctx.save_for_backward(volume_zyx, tf, out)
        return out

    @staticmethod
    def backward(ctx, g):
        volume_zyx, tf, out = ctx.saved_tensors
        diff_tf = ctx.needs_input_grad[1]
        d_volume, d_tf = march_exact_backward(
            volume_zyx, tf, ctx.view, out, g.contiguous(), diff_tf=diff_tf
        )
        return d_volume, (d_tf if diff_tf else None), None


def render_exact_diff(volume_zyx: torch.Tensor, tf: torch.Tensor, view: ExactView) -> torch.Tensor:
    """Differentiable exact render of one (Z, Y, X) f32 brick filling the
    view's box → (R, 4) rgba, with gradients for the volume and the
    (256, 4) TF.  Requires ``view.params.early_exit > 1`` (the trainer's
    semantics: the composite inversion needs every sample composited).
    Every ray direction is served: there is no fallback to refuse."""
    _require_no_early_exit("render_exact_diff", view.params)
    if volume_zyx.dtype != torch.float32 or volume_zyx.dim() != 3:
        raise TypeError(
            f"render_exact_diff: needs a (Z, Y, X) float32 volume, got "
            f"{tuple(volume_zyx.shape)} {volume_zyx.dtype}"
        )
    return RenderExactDiff.apply(volume_zyx, tf, view)


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
    view = exact_view(
        camera, params,
        world_min if global_min is None else global_min,
        world_max if global_max is None else global_max,
        world_min=world_min, world_max=world_max, clip_planes=clip_planes,
        sample_index=sample_index, device=dev,
    )
    carry = (
        torch.zeros((view.n_rays, 4), device=dev)
        if init_carry is None
        else init_carry.to(device=dev, dtype=torch.float32).contiguous()
    )
    return _march_view(volume_zyx, tf.to(dev).contiguous(), view, carry)


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
