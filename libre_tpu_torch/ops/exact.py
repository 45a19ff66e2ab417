"""Exact marcher on the card (``libre_tpu.ops.exact_pallas``): the wrappers
of K3 (``csrc/exact_march.cu``) and K4 (``csrc/exact_march_bwd.cu``), the
single-brick entry points and the differentiable march of a brick set.

:func:`march_exact` marches the rays of one pass through its bricks,
front to back, onto the carried (rgb, a): on a CUDA tensor it launches
the hand-written kernel, on a CPU tensor it runs the plain version
:func:`march_exact_reference` (``ops/raycast.py``, re-exported here), with
the same operands and result.  The engine's ``render`` (the ``xla`` and
``pallas-exact`` renderers) and :func:`render_exact_rays` /
:func:`render_exact` (BASELINE configs 1-2) call it.

:func:`render_marcher_diff` is the differentiable render of a brick set
(or of one brick) through one :class:`ExactView`: forward K3 over the
set's bricks in their order from a zero carry, backward
:func:`march_exact_backward` (K4 over the same set on a CUDA tensor,
``march_exact_backward_reference`` on a CPU one), with any early exit:
the counterpart of ``jax.grad`` of the JAX marcher ``raycast.render_rays``
(``models.VolumeScene``, ``parallel.render``, ``train.trainer``); with the
exit on K4 walks only the samples K3 composited.
:func:`render_exact_diff` is the same render with the early exit off
(the exact trainer's semantics).

The TF is any (T, 4) with T ≥ 1, as the JAX marcher's, on the CPU and on
the card: the kernels run a 256-entry TF through their fixed instances,
any other T up to ``EXACT_TF_MAX`` (4096) through their shared instances
(the TF, and K4's gradient table, in shared memory) and any larger T
through their global instances (the TF read from global memory, K4's TF
gradient flushed straight into ``d_tf``); :func:`tf_instance` names the
kind a T runs.

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
    BrickSet,
    Camera,
    RenderParams,
    max_steps_for_bricks,
)
from libre_tpu_torch.utils.profiling import span

__all__ = [
    "ATLAS_DTYPES", "EXACT_TF_MAX", "ExactView", "RenderMarcherDiff", "TF_INSTANCES",
    "exact_view", "march_exact", "march_exact_backward", "march_exact_backward_reference",
    "march_exact_reference", "render_exact", "render_exact_diff",
    "render_exact_rays", "render_marcher_diff", "tf_instance",
]

# Atlas dtypes the kernel reads in place, by its dtype code.
ATLAS_DTYPES = {torch.float32: 0, torch.uint8: 1, torch.uint16: 2}
# The largest TF the kernels' shared instances hold
# (csrc/exact_sample.cuh::kSharedTfMax): K4's hold the TF and its gradient
# table in shared memory.  Past it the global instances run.
EXACT_TF_MAX = 4096
# The kernels' instance kinds by where they keep the TF
# (csrc/exact_sample.cuh::tf_kind).
TF_INSTANCES = ("fixed", "shared", "global")


def tf_instance(n_tf: int) -> str:
    """The kind of K3's and K4's instance an ``n_tf``-entry TF runs:
    "fixed" at 256 entries, "shared" up to ``EXACT_TF_MAX``, "global"
    past it."""
    if n_tf < 1:
        raise ValueError(f"a TF has at least one entry, got {n_tf}")
    return "fixed" if n_tf == 256 else "shared" if n_tf <= EXACT_TF_MAX else "global"


def _count(wrapper, n_tf):
    """One launch of ``wrapper``'s kernel through the instance kind of an
    ``n_tf``-entry TF: ``wrapper.launches`` and
    ``wrapper.instance_launches[kind]``."""
    wrapper.launches += 1
    wrapper.instance_launches[tf_instance(n_tf)] += 1


def _check_operands(who, atlas, slots, boxes, tf, rays, params, per_ray, samples=None,
                    used=None):
    """Reject what the kernels do not take before a pointer reaches them.
    ``slots`` None means every brick of ``atlas`` in its order (the
    backward's set).  ``per_ray`` names the (R, 4) f32 operands (the carry,
    or the backward's forward output and cotangent).  The TF is any (T, 4)
    with T ≥ 1."""
    n_bricks = atlas.shape[0] if slots is None else slots.shape[0]
    n_rays = next(iter(per_ray.values())).shape[0]
    n_tf = tf.shape[0] if tf.dim() == 2 else 0
    expect = {
        "boxes": (boxes, torch.float32, (n_bricks, BOX_FLOATS)),
        "tf": (tf, torch.float32, (max(n_tf, 1), 4)),
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
    (``march_exact.launches`` counts the launches, and
    ``march_exact.instance_launches`` by :func:`tf_instance`); ``width`` is the
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
            -lo / (hi - lo), params.alpha_correction, params.early_exit, tf.shape[0],
        )
    _count(march_exact, tf.shape[0])
    return out


march_exact.launches = 0
march_exact.instance_launches = dict.fromkeys(TF_INSTANCES, 0)


def march_exact_backward(
    volume: torch.Tensor,
    tf: torch.Tensor,
    view: "ExactView",
    out: torch.Tensor,
    g: torch.Tensor,
    *,
    diff_tf: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute backward of :func:`render_marcher_diff`'s forward (and
    :func:`render_exact_diff`'s) → (d_volume shaped as ``volume``, d_tf
    (T, 4)), with the early exit of ``view.params``: on (≤ 1), only the
    samples the forward composited take part.

    Operands and result as :func:`march_exact_backward_reference`: the
    (B, BZ, BY, BX) f32 brick set placed by ``view``'s B box rows and
    marched in their order (a (Z, Y, X) volume is the one-brick set), the
    TF, the forward's output ``out`` (marched from a zero carry) and its
    cotangent ``g``; with ``diff_tf`` false the TF gradient is not
    accumulated and ``d_tf`` comes back zero.
    On a CUDA tensor this zeroes the gradients and launches
    ``csrc/exact_march_bwd.cu`` on the current stream, in tiles of
    ``view.width`` rays per row (``march_exact_backward.launches`` counts
    the launches, ``instance_launches`` by :func:`tf_instance`); on a CPU tensor it runs the plain version; on any other
    device it raises."""
    who = "march_exact_backward"
    if volume.dtype != torch.float32:
        raise TypeError(f"{who}: the volume is {volume.dtype}, needs float32")
    if volume.dim() not in (3, 4):
        raise ValueError(
            f"{who}: needs a (B, BZ, BY, BX) brick set or a (Z, Y, X) brick, got "
            f"{tuple(volume.shape)}"
        )
    bricks = volume if volume.dim() == 4 else volume[None]
    boxes, rays, params = view.brick_boxes, view.ray_pack, view.params
    _check_operands(who, bricks, None, boxes, tf, rays, params, {"out": out, "g": g})
    if volume.device.type == "cpu":
        return march_exact_backward_reference(volume, tf, view, out, g, diff_tf=diff_tf)
    if volume.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {volume.device}")
    for name, x in (("boxes", boxes), ("tf", tf), ("out", out), ("g", g)):
        if x.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")
    d_volume = torch.zeros_like(volume)
    d_tf = torch.zeros_like(tf)
    n_rays = out.shape[0]
    if n_rays == 0:
        return d_volume, d_tf
    lo, hi = params.data_source_range
    n_bricks, bz, by, bx = bricks.shape
    ex, ey, ez = (float(v) for v in view.eye)
    with torch.cuda.device(volume.device):
        _kernels.launch(
            "exact_march_bwd",
            bricks, boxes, tf, rays, out, g, d_volume, d_tf,
            int(params.filter_mode == "trilinear"), int(diff_tf), n_bricks, n_rays,
            int(view.width), bx, by, bz, int(view.max_steps), ex, ey, ez, params.step_size,
            1.0 / (hi - lo), -lo / (hi - lo), params.alpha_correction, params.early_exit,
            tf.shape[0],
        )
    _count(march_exact_backward, tf.shape[0])
    return d_volume, d_tf


march_exact_backward.launches = 0
march_exact_backward.instance_launches = dict.fromkeys(TF_INSTANCES, 0)


def _require_no_early_exit(who, params: RenderParams):
    if float(params.early_exit) <= 1.0:
        raise ValueError(
            f"{who} requires early_exit > 1 (disabled): the composite inversion "
            f"needs every sample composited"
        )


@dataclasses.dataclass(frozen=True)
class ExactView:
    """What fixes one camera's sample grid over a brick set, computed once
    (the part of the JAX package's ``ExactPlan`` a per-ray kernel needs):
    the (8, R) ``ray_pack``, the (B, 16) ``brick_boxes`` in march order,
    the ``eye``, the march length ``max_steps`` (the longest brick's), the
    screen ``width`` the kernels tile the rays by, and the marching
    ``params``."""

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
    bricks: Optional[BrickSet] = None,
    clip_planes: Optional[np.ndarray] = None,
    sample_index: int = 0,
    device="cuda",
) -> ExactView:
    """The :class:`ExactView` of ``camera``'s rays (jittered subpixel
    sample ``sample_index``) on ``device``, over one brick without ghost
    voxels that fills ``world_min/max`` (default: the global box, the
    single-brick form), or over the bricks of ``bricks`` (their world boxes
    and texture insets, in their order; the far-away pads of
    ``parallel.render.shard_bricks_front_to_back`` would make ``max_steps``
    their own length, so build such a set's view with the real bricks'
    ``max_steps``).  The sample grid is the global box's
    (fragRaycast.glsl:152-158)."""
    with span("libre.exact.view"):
        if bricks is not None:
            if world_min is not None or world_max is not None:
                raise ValueError("exact_view: pass either bricks or world_min/max")

            def host(t):
                return t.detach().cpu().numpy()

            wmin, wmax = host(bricks.world_min), host(bricks.world_max)
            tmin, tmax = host(bricks.tex_min), host(bricks.tex_max)
        else:
            wmin = global_min if world_min is None else world_min
            wmax = global_max if world_max is None else world_max
            tmin, tmax = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)
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
            brick_boxes=brick_boxes(wmin, wmax, tmin, tmax).to(device),
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


class RenderMarcherDiff(torch.autograd.Function):
    """Forward: K3 over the set's bricks (slots ``arange(B)``) from a zero
    carry; backward: K4 over the same set (or their plain versions on the
    CPU), with the view's early exit, accumulating the TF gradient only
    when the TF needs one.  Saves (volume, tf, out), as the JAX package's
    ``_red_fwd``."""

    @staticmethod
    def forward(ctx, volume, tf, view: ExactView):
        with span("libre.exact.forward"):
            volume, tf = volume.contiguous(), tf.contiguous()
            bricks = volume if volume.dim() == 4 else volume[None]
            dev = volume.device
            out = march_exact(
                bricks, torch.arange(bricks.shape[0], dtype=torch.int32, device=dev),
                view.brick_boxes, tf, view.ray_pack, torch.zeros((view.n_rays, 4), device=dev),
                view.eye, view.params, max_steps=view.max_steps, width=view.width,
            )
        ctx.view = view
        ctx.save_for_backward(volume, tf, out)
        return out

    @staticmethod
    def backward(ctx, g):
        volume, tf, out = ctx.saved_tensors
        diff_tf = ctx.needs_input_grad[1]
        with span("libre.exact.backward"):
            d_volume, d_tf = march_exact_backward(
                volume, tf, ctx.view, out, g.contiguous(), diff_tf=diff_tf
            )
        return d_volume, (d_tf if diff_tf else None), None


def render_marcher_diff(volume: torch.Tensor, tf: torch.Tensor, view: ExactView) -> torch.Tensor:
    """Differentiable render of a (B, Z, Y, X) f32 brick set, placed by
    the view's B box rows and marched in their order, or of one (Z, Y, X)
    brick → (R, 4) rgba, with any early exit (``view.params.early_exit``):
    the counterpart of ``jax.grad`` of the JAX marcher
    ``raycast.render_rays`` over the same bricks in the same order.
    Forward K3 from a zero carry, backward K4 over the set with the exit
    rule (their plain versions on the CPU); a sample past the exit gets no
    gradient."""
    if volume.dtype != torch.float32 or volume.dim() not in (3, 4):
        raise TypeError(
            f"render_marcher_diff: needs a (B, Z, Y, X) or (Z, Y, X) float32 volume, got "
            f"{tuple(volume.shape)} {volume.dtype}"
        )
    return RenderMarcherDiff.apply(volume, tf, view)


def render_exact_diff(volume: torch.Tensor, tf: torch.Tensor, view: ExactView) -> torch.Tensor:
    """:func:`render_marcher_diff` for the exact trainer: requires
    ``view.params.early_exit > 1`` (the composite inversion of the JAX
    package's ``render_exact_diff`` needs every sample composited).
    Every ray direction is served: there is no fallback to refuse."""
    _require_no_early_exit("render_exact_diff", view.params)
    return render_marcher_diff(volume, tf, view)


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
