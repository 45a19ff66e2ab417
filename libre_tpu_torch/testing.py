"""Seeded operands, tolerances and the checks that apply them, for
holding the port's kernels against their plain PyTorch versions
(``chip_smoke.py``, the benchmark scripts and the CUDA tests)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.ops.transfer_function import default_color_map

KERNEL_TOL_MAX = 2e-3  # one flip of the early-exit test moves a pixel ≤ 1 − 0.999
KERNEL_TOL_MEAN = 1e-5  # powf vs torch.pow rounding
# Backward kernel vs plain, each gradient normalised by the plain one's
# max |·|.  Early exit off: only the summation order (float atomics) and
# powf differ.  Early exit on: a ray whose recomputed t crosses the
# threshold one plane apart in the two versions changes its whole
# gradient, so the max is looser and the mean holds the rest.
GRAD_TOL_MAX = 1e-3
GRAD_TOL_MAX_EARLY_EXIT = 1e-2
GRAD_TOL_MEAN_EARLY_EXIT = 1e-5
# The Adam kernel (csrc/adam_update.cu, no contraction) vs torch.optim.Adam's
# CUDA kernels (which contract products into sums): f32 ulps, relative to
# each value and absolute to the leaf's range, over ten steps.
ADAM_TOL_ULPS = 8


def compare(got, want, what, tol=None):
    """(max, mean) |got − want|; raises past ``tol`` = (max, mean), by
    default the sweep kernel's tolerances."""
    tol_max, tol_mean = tol or (KERNEL_TOL_MAX, KERNEL_TOL_MEAN)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d| {mx:.3e} mean|d| {mean:.3e}")
    if mx > tol_max or mean > tol_mean:
        raise AssertionError(
            f"{what}: kernel disagrees with plain (max {mx}, mean {mean})"
        )
    return mx


def compare_grads(got, want, what, early_exit, tol_max=None, expect_zero=False):
    """Normalised (max, mean) |got − want| / max |want|; raises past the
    backward kernels' tolerances (``tol_max``: the max with the early
    exit off, by default K2's).  With ``expect_zero`` (K4's density
    gradient on the "top" field: every sample past the density gate) both
    must be exactly zero; otherwise a zero plain gradient raises."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    scale = float(want.abs().max())
    if expect_zero:
        mx = float(got.abs().max())
        print(f"{what}: expected zero, max|kernel| {mx:.3e}, max|plain| {scale:.3e}")
        if mx != 0.0 or scale != 0.0:
            raise AssertionError(f"{what}: gradient not zero (kernel {mx}, plain {scale})")
        return 0.0
    if scale == 0.0:
        raise AssertionError(f"{what}: the plain gradient is zero")
    err = (got - want).abs() / scale
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d|/max|plain| {mx:.3e} mean {mean:.3e} (max|plain| {scale:.3e})")
    if early_exit < 1.0:
        bad = mx > GRAD_TOL_MAX_EARLY_EXIT or mean > GRAD_TOL_MEAN_EARLY_EXIT
    else:
        bad = mx > (GRAD_TOL_MAX if tol_max is None else tol_max)
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with plain ({mx}, {mean})")
    return mx


# The seeded sweep views, by name: (eye_a, eb, ec, sign, slope bounds
# (u0, u1, v0, v1)) over the box [−0.5, 0.5]³.  "axis" is the
# tests/test_bricked.py scene (eye at a = 1.4, marching toward −a);
# "inside" puts the eye inside the volume (dl changes sign along the
# sweep), marching toward +a; "oblique" takes slopes up to 2.5, so that a
# tile's rays spread over most of a slice at the far planes and most
# tiles see the box at a few planes only.
SWEEP_VIEWS = {
    "axis": (1.4, 0.1, 0.05, -1.0, (-0.45, 0.45, -0.4, 0.4)),
    "inside": (-0.15, 0.1, -0.05, 1.0, (-0.6, 0.6, -0.5, 0.5)),
    "oblique": (1.4, 0.3, -0.2, -1.0, (-2.5, 2.5, -2.0, 2.0)),
}


def sweep_case(shape, seed, device, view="axis"):
    """Seeded sweep operands: a random (Na, Nc, Nb) density store with
    SENTINEL holes, a saturating TF, two clip planes, every 7th plane
    inactive, seen from ``SWEEP_VIEWS[view]``.  ``shape`` = (V, U, K, Na,
    Nc, Nb).

    Returns (store, tf, tables, clip, keyword arguments of post_sweep)."""
    v_size, u_size, k_planes, na, nc, nb = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    store = torch.rand((na, nc, nb), generator=gen, device=device)
    holes = torch.rand(
        (na // 16 + 1, nc // 16 + 1, nb // 16 + 1), generator=gen, device=device
    ) < 0.15
    holes = holes.repeat_interleave(16, 0).repeat_interleave(16, 1)
    holes = holes.repeat_interleave(16, 2)[:na, :nc, :nb]
    store = torch.where(holes, swb.SENTINEL, store).contiguous()

    tf = default_color_map()
    tf[:, 3] = np.clip(8.0 * tf[:, 3], 0.0, 1.0)
    eye_a, eb, ec, sign, (u0, u1, v0, v1) = SWEEP_VIEWS[view]
    a0, a1, wa, dl, _z, dz = swb.plane_tables(
        na=na, k_planes=k_planes, wa0=-0.5, wa1=0.5, eye_a=eye_a, sign=sign
    )
    du, dv = (u1 - u0) / (u_size - 1), (v1 - v0) / (v_size - 1)
    ug = u0 + du * np.arange(u_size, dtype=np.float32)
    vg = v0 + dv * np.arange(v_size, dtype=np.float32)
    corr = 32.0 * dz * np.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
    act = np.ones(k_planes, np.int32)
    act[::7] = 0
    clip_m, n_clip = swb.clip_matrix(
        np.float32([[1.0, 0.0, 0.0, 0.1], [0.0, -1.0, 0.5, 0.2]]), 2
    )

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    tables = swb.SweepTables(
        a0=dev(a0, torch.int32),
        a1=dev(a1, torch.int32),
        wa=dev(wa),
        dl=dev(dl),
        act=dev(act, torch.int32),
        view=dev(np.float32([u0, du, dv, eb, ec, v0, eye_a, 0.0])),
        corr=dev(corr),
        rgb_in=torch.zeros((v_size, u_size, 4), device=device),
        t_in=torch.ones((v_size, u_size), device=device),
    )
    kw = dict(n_clip=n_clip, wb=(-0.5, 0.5), wc=(-0.5, 0.5), early_exit=0.999)
    return store, dev(tf), tables, dev(clip_m), kw


# The density fields of the backward kernels' seeded cases.  "random" is
# uniform noise: neighbouring samples fall in unrelated TF bins.  The
# others exercise the TF-gradient runs of csrc/tf_grad.cuh: "flat" puts
# every sample in one bin (the trainers' flat-0.5 start), "top" in bin
# 255, where i0 == i1, and "smooth" moves the bin every few samples.
FIELDS = ("random", "flat", "top", "smooth")


def field_volume(field, shape, seed, device):
    """A seeded f32 density field of ``shape`` on ``device``, for the
    ``FIELDS`` other than "random": "flat" a constant 0.5 (TF coordinate
    127.5: bins 127 and 128), "top" a constant 1.25 (clamped to 1: bin
    255 with i0 == i1, and no density gradient), "smooth" the sum of
    three plane waves of at most one period across the box, their
    directions and phases drawn with numpy from ``seed``, scaled to
    [0.1, 0.9]."""
    if field == "flat":
        return torch.full(shape, 0.5, dtype=torch.float32, device=device)
    if field == "top":
        return torch.full(shape, 1.25, dtype=torch.float32, device=device)
    if field != "smooth":
        raise ValueError(f"field_volume: unknown field {field!r}")
    rng = np.random.default_rng(seed)
    axes = [torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device) for n in shape]
    vol = torch.zeros(shape, dtype=torch.float32, device=device)
    for _ in range(3):
        k = rng.uniform(-np.pi, np.pi, 3).astype(np.float32)
        phase = float(rng.uniform(0.0, 2.0 * np.pi))
        vol += torch.sin(
            float(k[0]) * axes[0][:, None, None] + float(k[1]) * axes[1][None, :, None]
            + float(k[2]) * axes[2][None, None, :] + phase
        )
    vol = (vol - vol.min()) / (vol.max() - vol.min())
    return 0.1 + 0.8 * vol


def store_grad_case(shape, seed, device, early_exit, field="random"):
    """Seeded operands of the backward sweep: the ``sweep_case`` view and
    store (SENTINEL holes, every 7th plane inactive) with no clip planes,
    the forward's ``out``/``t_out`` from ``post_sweep`` and a standard
    normal cotangent ``g``.  With ``early_exit`` < 1 the TF saturates
    (alpha × 8) so the early exit fires; otherwise it is the default map.
    ``shape`` = (V, U, K, Na, Nc, Nb).  ``field`` (``FIELDS``) other than
    "random" replaces the store's densities outside the holes with
    ``field_volume``.

    Returns (store, tf, tables, out, t_out, g, keyword arguments of
    ``store_grid_backward`` without ``diff_tf``)."""
    store, tf, tables, clip, kw = sweep_case(shape, seed, device)
    if field != "random":
        dens = field_volume(field, tuple(store.shape), seed, device)
        store = torch.where(store == swb.SENTINEL, swb.SENTINEL, dens).contiguous()
    if early_exit >= 1.0:
        tf = torch.as_tensor(default_color_map()).to(device)
    kw = dict(wb=kw["wb"], wc=kw["wc"], early_exit=early_exit)
    out, t_out = swb.post_sweep(
        store, tf, tables, torch.zeros_like(clip), n_clip=0, **kw
    )
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    g = torch.randn(out.shape, generator=gen).to(device)
    return store, tf, tables, out, t_out, g, kw


# The exact marcher (K3) vs its plain version.  The kernel composites one
# sample at a time; the plain version folds chunks of 32 samples in closed
# form (raycast._composite_chunk), so their sums round differently (~1e-6).
# Where that moves a ray's accumulated alpha across the early-exit
# threshold one sample apart, the pixel moves by at most 1 − 0.999 plus
# one sample's contribution; the mean holds the rest to the rounding.
EXACT_TOL_MAX = 2e-3
EXACT_TOL_MEAN = 1e-5


class ExactCase(NamedTuple):
    """Operands of one pass of ``exact.march_exact``."""

    atlas: torch.Tensor
    slots: torch.Tensor
    boxes: torch.Tensor
    tf: torch.Tensor
    rays: torch.Tensor
    carry: torch.Tensor
    eye: np.ndarray
    params: RenderParams
    max_steps: int
    width: int


# The multi-brick exact views, by case: (eye, look-at point, (width,
# height), subpixel sample, saturating TF).  "bricks" looks at the grid
# from off axis; "inside" puts the eye inside the volume on a corner of
# eight bricks, "in_brick" inside one brick; "grazing" looks down −z with
# an odd width, so its middle column of rays runs in the x = 0 brick
# faces; "jitter" marches the jittered subpixel sample 1.
EXACT_BRICK_VIEWS = {
    "bricks": ((0.55, 0.4, 1.3), (0.0, 0.0, 0.0), (100, 70), 0, True),
    "inside": ((0.0, 0.25, -0.25), (0.3, -0.2, 0.4), (48, 40), 0, False),
    "in_brick": ((0.37, -0.13, 0.11), (-0.4, 0.2, -0.3), (48, 40), 0, False),
    "grazing": ((0.0, 0.13, 1.3), (0.0, 0.13, 0.0), (33, 24), 0, False),
    "jitter": ((-0.6, 0.35, 1.1), (0.0, 0.0, 0.0), (48, 40), 1, False),
}


def tf_of_size(n_tf: int) -> np.ndarray:
    """The (n_tf, 4) f32 TF of the runtime-T cases: the default colormap
    at ``n_tf`` entries (its single-entry form is transparent, so one
    entry is an opaque-enough constant colour)."""
    if n_tf == 1:
        return np.float32([[0.9, 0.6, 0.3, 0.35]])
    return default_color_map(n_tf)


def exact_case(case, seed, device, *, filter_mode="trilinear", dtype=torch.float32,
               n_tf=256):
    """Seeded operands of the exact march.

    ``case`` = "single": scene "bench" of ``EXACT_SCENES`` (bench.py's
    ``bench_exact`` shape: one 64³ random brick filling [−0.5, 0.5]³, 256²
    rays), the default TF, zero carry.

    Any case of ``EXACT_BRICK_VIEWS``: a 4×4×4 grid of 16³ bricks with
    2-voxel ghosts (20³ slots, random ghost voxels) scattered over a
    72-slot atlas and marched front to back, seen through that view's
    camera (ragged 16×8 tiles); 256 samples per ray; two clip planes; the
    default TF, or with "saturating TF" alpha × 8 so the early exit
    fires; a seeded carry in, with every 9th ray already past the
    early-exit threshold.

    ``dtype`` is the atlas's: float32 (data range [0, 1]) or uint8 (data
    range [0, 255]); ``n_tf`` the TF's entries (``tf_of_size``).  Returns
    an :class:`ExactCase`."""
    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops.raycast import (
        brick_boxes,
        ray_pack,
        sort_bricks_front_to_back,
    )
    from libre_tpu_torch.ops.reference import max_steps_for_bricks

    rng = np.random.default_rng(seed)
    tf = tf_of_size(n_tf)
    if case == "single":
        shape = (1, *EXACT_SCENES["bench"][0])
    elif case in EXACT_BRICK_VIEWS:
        grid, brick, ghost, n_slots, spr = 4, 16, 2, 72, 256
        eye, target, (width, height), sample, saturating = EXACT_BRICK_VIEWS[case]
        clip = np.float32([[1.0, 0.0, 0.0, 0.3], [0.0, -1.0, 0.5, 0.2]])
        if saturating:
            tf[:, 3] = np.clip(8.0 * tf[:, 3], 0.0, 1.0)
        padded = brick + 2 * ghost
        shape = (n_slots, padded, padded, padded)
    else:
        raise ValueError(f"exact_case: unknown case {case!r}")
    if dtype == torch.uint8:
        data = rng.integers(0, 256, shape, dtype=np.uint8)
        data_range = (0.0, 255.0)
    else:
        data = rng.random(shape, dtype=np.float32)
        data_range = (0.0, 1.0)
    if case == "single":
        view = _exact_scene_view(
            "bench", device, data_source_range=data_range, filter_mode=filter_mode
        )
        return ExactCase(
            atlas=torch.from_numpy(data).to(device),
            slots=torch.zeros(1, dtype=torch.int32, device=device),
            boxes=view.brick_boxes,
            tf=torch.from_numpy(tf).to(device),
            rays=view.ray_pack,
            carry=torch.zeros((view.n_rays, 4), device=device),
            eye=view.eye,
            params=view.params,
            max_steps=view.max_steps,
            width=view.width,
        )
    params = RenderParams(
        n_samples_per_ray=spr, data_source_range=data_range, filter_mode=filter_mode
    )

    cells = np.stack(np.meshgrid(*[np.arange(grid)] * 3, indexing="ij"), -1)
    wmin = (cells.reshape(-1, 3) / grid - 0.5).astype(np.float32)
    wmax = ((cells.reshape(-1, 3) + 1) / grid - 0.5).astype(np.float32)
    camera, _frustum = build_camera(width, height, eye, target)
    eye_np = np.asarray(camera.inv_mv, np.float32)[:3, 3]
    order = sort_bricks_front_to_back(wmin, wmax, eye_np)
    slots = rng.permutation(n_slots)[: len(wmin)][order].astype(np.int32)
    boxes = brick_boxes(
        wmin[order], wmax[order],
        np.full((len(order), 3), ghost / padded, np.float32),
        np.full((len(order), 3), (ghost + brick) / padded, np.float32),
    )

    eye_t, dirs, cos_z, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport, sample_index=sample, device=device
    )
    dirs = dirs.reshape(-1, 3)
    tnp = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
    rays = ray_pack(eye_t, dirs, tnp, params.step_size, wmin.min(0), wmax.max(0), clip)
    n_rays = width * height
    carry = np.zeros((n_rays, 4), np.float32)
    a = rng.uniform(0.0, 0.6, n_rays).astype(np.float32)
    a[::9] = 0.9995
    carry[:, :3] = rng.uniform(0.0, 1.0, (n_rays, 3)).astype(np.float32) * a[:, None]
    carry[:, 3] = a
    return ExactCase(
        atlas=torch.from_numpy(data).to(device),
        slots=torch.from_numpy(slots).to(device),
        boxes=boxes.to(device),
        tf=torch.from_numpy(tf).to(device),
        rays=rays,
        carry=torch.from_numpy(carry).to(device),
        eye=eye_np,
        params=params,
        max_steps=max_steps_for_bricks(wmin, wmax, params.step_size),
        width=width,
    )


# The exact backward K4 vs its plain version, each gradient normalised by
# the plain one's max |·|, early exit off (on: GRAD_TOL_MAX_EARLY_EXIT and
# GRAD_TOL_MEAN_EARLY_EXIT, as K2's, since the plain K4 stops where the
# plain K3's closed-form mask stops, a sample apart from K3 on a few rays).  Both visit the same samples
# with the same values (exact_sample.cuh, --fmad=false); the kernel
# composites serially and adds with float atomics in a run-dependent order,
# the plain version takes closed-form cumulative products and sums, so
# the inversion (TOT − P)/(1 − α) cancels in another rounding.
EXACT_GRAD_TOL_MAX = 1e-3


class ExactGradCase(NamedTuple):
    """Operands of ``exact.march_exact_backward``: one f32 volume
    filling the view's box, or a brick set placed by its box rows."""

    volume: torch.Tensor  # (Z, Y, X) or (B, BZ, BY, BX)
    tf: torch.Tensor
    view: exact.ExactView
    out: torch.Tensor  # (R, 4), the forward from a zero carry
    g: torch.Tensor  # (R, 4)


# The single-brick scenes, by case: (volume shape (Z, Y, X), (width,
# height), eye, samples per ray, clip planes, subpixel sample).  "bench" is
# bench.py's bench_exact and exact_fwd_bwd shape (:279-291, :379-413): a 64³
# volume filling [−0.5, 0.5]³, 256² rays from (0.2, 0.1, 1.4), 512 samples
# per ray.  "wide" is a (24, 144, 136) volume, so the two extents across
# the major (z) axis exceed 128, seen by 96×80 rays from (0.25, 0.15, 1.3)
# at 256 samples per ray, with two clip planes and jittered sample 1.
EXACT_SCENES = {
    "bench": ((64, 64, 64), (256, 256), (0.2, 0.1, 1.4), 512, None, 0),
    "wide": ((24, 144, 136), (96, 80), (0.25, 0.15, 1.3), 256,
             np.float32([[1.0, 0.0, 0.0, 0.3], [0.0, -1.0, 0.5, 0.2]]), 1),
}


def _exact_scene_view(case, device, **params):
    """The :class:`exact.ExactView` of scene ``case`` (``EXACT_SCENES``),
    with ``params`` for the rest of its ``RenderParams``."""
    from libre_tpu_torch.apps.render_cli import build_camera

    _shape, (width, height), eye, spr, clip, sample = EXACT_SCENES[case]
    camera, _frustum = build_camera(width, height, eye, (0.0, 0.0, 0.0))
    return exact.exact_view(
        camera, RenderParams(n_samples_per_ray=spr, **params), clip_planes=clip,
        sample_index=sample, device=device,
    )


def exact_grad_case(case, seed, device, *, filter_mode="trilinear", field="random",
                    early_exit=1.1, n_tf=256):
    """Seeded K4 operands over scene ``case`` of ``EXACT_SCENES``: an f32
    volume (uniform random, or ``field_volume(field)`` for the other
    ``FIELDS``), the default TF (at ``n_tf`` entries, ``tf_of_size``), the
    early exit off (or ``early_exit``);
    ``g`` is a standard normal cotangent and ``out`` the forward
    (``march_exact``, so K3 on a CUDA device)."""
    if case not in EXACT_SCENES:
        raise ValueError(f"exact_grad_case: unknown case {case!r}")
    rng = np.random.default_rng(seed)
    view = _exact_scene_view(
        case, device, data_source_range=(0.0, 1.0), filter_mode=filter_mode,
        early_exit=early_exit,
    )
    shape = EXACT_SCENES[case][0]
    # Drawn for every field, so that g is the same for all of them.
    volume = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(device)
    if field != "random":
        volume = field_volume(field, shape, seed, device)
    tf = torch.from_numpy(tf_of_size(n_tf)).to(device)
    with torch.no_grad():
        out = exact.render_marcher_diff(volume, tf, view)
    g = torch.from_numpy(rng.standard_normal((view.n_rays, 4)).astype(np.float32)).to(device)
    return ExactGradCase(volume, tf, view, out, g)


def exact_set_grad_case(seed, device, *, filter_mode="trilinear", early_exit=1.1, n_tf=256):
    """Seeded K4 operands over a brick set: a uniform random 64³ f32
    volume in 4³ bricks with two ghost voxels (``split_into_bricks``, 20³
    each), sorted front to back from the "bench" scene's eye and padded
    to 66 by ``parallel.render.shard_bricks_front_to_back`` (its two
    far-away pads at the end), 128² rays at 256 samples per ray, the
    default TF (at ``n_tf`` entries), the early exit off (or
    ``early_exit``); the view's ``max_steps`` is the real bricks'.  ``volume`` is the (66, 20, 20,
    20) set, ``out`` the forward over it (K3 over slots ``arange(66)`` on
    a CUDA device) and ``g`` a standard normal cotangent."""
    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.parallel.render import shard_bricks_front_to_back

    rng = np.random.default_rng(seed)
    eye = EXACT_SCENES["bench"][2]
    bricks = split_into_bricks(rng.random((64,) * 3, dtype=np.float32), 4, 2, device=device)
    sharded, _ = shard_bricks_front_to_back(bricks, np.float32(eye), 3)
    camera, _frustum = build_camera(128, 128, eye, (0.0, 0.0, 0.0))
    params = RenderParams(n_samples_per_ray=256, data_source_range=(0.0, 1.0),
                          filter_mode=filter_mode, early_exit=early_exit)
    view = exact.exact_view(camera, params, bricks=sharded, device=device)
    real = exact.exact_view(camera, params, bricks=bricks, device=device)
    view = dataclasses.replace(view, max_steps=real.max_steps)
    tf = torch.from_numpy(tf_of_size(n_tf)).to(device)
    with torch.no_grad():
        out = exact.render_marcher_diff(sharded.data, tf, view)
    g = torch.from_numpy(rng.standard_normal((view.n_rays, 4)).astype(np.float32)).to(device)
    return ExactGradCase(sharded.data, tf, view, out, g)


def smooth_volume(n, seed=7, device="cuda"):
    """A smooth (n, n, n) f32 density in [0, 1] on ``device``: the sum of
    six seeded Gaussian blobs, normalised by its max (the torch copy of
    benchmarks/demo_inverse_render.py:41-54; the blobs' centres, widths
    and heights are drawn with numpy from ``seed``, the field is
    computed on the device)."""
    rng = np.random.default_rng(seed)
    g = torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
    x, y, z = g[None, None, :], g[None, :, None], g[:, None, None]
    vol = torch.zeros((n, n, n), dtype=torch.float32, device=device)
    for _ in range(6):
        c = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        s = rng.uniform(0.15, 0.4)
        a = rng.uniform(0.4, 1.0)
        r2 = (x - float(c[0])) ** 2 + (y - float(c[1])) ** 2 + (z - float(c[2])) ** 2
        vol += a * torch.exp(-r2 / (2 * s * s))
    return torch.clamp(vol / vol.max(), 0.0, 1.0)


# The dense sweep K5 vs its plain version takes K1's tolerances
# (KERNEL_TOL_MAX, KERNEL_TOL_MEAN): the two share every sample's
# arithmetic and order (sweep_sample.cuh, --fmad=false); powf and
# torch.pow round differently, and where that moves a ray's alpha across
# the early-exit threshold a plane apart, the pixel moves by at most
# 1 − 0.999.  The dense autograd Function on the card vs on the CPU, each
# gradient normalised by the CPU's max |·|, early exit off: the same plain
# recompute, summed in another order (f32 einsum on the card, no TF32).
DENSE_GRAD_TOL = 1e-4

# The JAX package's dense test scene (tests/test_shearwarp_pallas.py:32-54):
# a non-cubic box and four eyes covering every major axis and both signs.
DENSE_BOX = (np.float32([-0.5, -0.4, -0.3]), np.float32([0.5, 0.4, 0.3]))
DENSE_EYES = {"z-": (0.2, 0.1, 1.4), "x-": (1.4, 0.1, 0.2), "y-": (0.1, 1.4, -0.2),
              "z+": (-0.2, -0.1, -1.4)}


class DenseCase(NamedTuple):
    """Operands of ``shearwarp_dense.pre_sweep``."""

    chans: torch.Tensor  # (Na, Nc, Nb, 4)
    tables: swb.SweepTables
    kw: dict  # wb, wc, early_exit


# The "sweep" dense case's shapes (V, U, K, Na, Nc, Nb): ragged tiles in u
# and v with K ≠ Na, and K = Na.
DENSE_SWEEP_SHAPES = ((40, 72, 80, 48, 40, 44), (20, 40, 48, 48, 24, 28))


def dense_case(case, seed, device, eye="z-", view="axis", shape=DENSE_SWEEP_SHAPES[0]):
    """Seeded operands of the dense sweep.

    ``case`` = "scene": the JAX package's dense test scene, a 20×24×28
    volume in ``DENSE_BOX``, zero outside a central block of random
    densities in [0.5, 1), seen from ``DENSE_EYES[eye]`` (a 32² camera)
    through a (24, 40) slope grid with 24 planes; the TF is the default
    map with alpha × 8, and alpha 0 on its lower half, so the outer
    slices classify empty (``act`` 0) and the early exit fires.

    ``case`` = "slice": a random 512³ RGBA stack made on ``device``
    (uniform channels; slices 0-39, 250-259 and 472-511 empty) under the
    ``sweep_case`` view: eye at a = 1.4 marching toward −a through
    [−0.5, 0.5]³, 512² slope rays in u ∈ [−0.45, 0.45], v ∈ [−0.4, 0.4],
    K = 512, early exit 0.999.

    ``case`` = "sweep": a random (Na, Nc, Nb, 4) stack of ``shape`` = (V,
    U, K, Na, Nc, Nb) (alpha in [0, 0.5); slices 0-3, 20-23 and 44-47
    empty) under the ``sweep_case`` tables of ``SWEEP_VIEWS[view]``, with
    ``act`` from the stack's slice content: with the eye inside the volume
    ("inside") dl changes sign along the sweep, which runs toward +a
    there and toward −a on the other views.

    Returns a :class:`DenseCase`."""
    if case == "scene":
        from libre_tpu_torch.apps.render_cli import build_camera

        rng = np.random.default_rng(seed)
        vol = np.zeros((20, 24, 28), np.float32)
        vol[7:13, 8:16, 9:19] = rng.random((6, 8, 10), dtype=np.float32) * 0.5 + 0.5
        tf = default_color_map()
        tf[:, 3] = np.clip(8.0 * tf[:, 3], 0.0, 1.0)
        tf[:128, 3] = 0.0
        camera, _frustum = build_camera(32, 32, DENSE_EYES[eye], (0.0, 0.0, 0.0))
        plan = sw.make_view_plan(camera)
        params = RenderParams(n_samples_per_ray=24, data_source_range=(0.0, 1.0))
        swp = sw.ShearWarpParams(n_planes=24, inter_size=(24, 40))
        world = DENSE_BOX
        chans = swd.classify_planes(
            torch.from_numpy(vol).to(device), torch.from_numpy(tf).to(device),
            plan.axis, params.data_source_range,
        )
    elif case == "slice":
        n = 512
        gen = torch.Generator(device=device).manual_seed(seed)
        chans = torch.rand((n, n, n, 4), generator=gen, device=device)
        for lo, hi in ((0, 40), (250, 260), (472, 512)):
            chans[lo:hi] = 0.0
        plan = sw.ViewPlan(axis=2, sign=-1.0, bounds=(-0.45, 0.45, -0.4, 0.4),
                           eye=np.float32([0.1, 0.05, 1.4]))
        params = RenderParams(n_samples_per_ray=n, data_source_range=(0.0, 1.0))
        swp = sw.ShearWarpParams(n_planes=n, inter_size=(n, n))
        world = (np.float32([-0.5] * 3), np.float32([0.5] * 3))
    elif case == "sweep":
        _store, _tf, tables, _clip, kw = sweep_case(shape, seed, device, view=view)
        _v, _u, _k, na, nc, nb = shape
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        chans = torch.rand((na, nc, nb, 4), generator=gen, device=device)
        chans[..., 3] *= 0.5
        for lo, hi in ((0, 4), (20, 24), (44, 48)):
            chans[lo:hi] = 0.0
        content = swd.slice_content(chans)
        act = content[tables.a0.long()] | content[tables.a1.long()]
        kw = dict(wb=kw["wb"], wc=kw["wc"], early_exit=kw["early_exit"])
        return DenseCase(chans, dataclasses.replace(tables, act=act), kw)
    else:
        raise ValueError(f"dense_case: unknown case {case!r}")
    pa = swd.slope_grid_plan_args(plan, *world, params, swp)
    _fv, tables = swd.sweep_operands(chans, pa, content=swd.slice_content(chans))
    return DenseCase(chans, tables, pa.sweep_kwargs())


def dense_plain(c: DenseCase):
    """(plain sweep, (TV, TU, K) planes each tile composites at, plain
    plane lists) of a :class:`DenseCase`."""
    lists = swb.tile_planes_reference(c.tables, c.kw["wb"], c.kw["wc"])
    fetches = torch.zeros_like(lists)
    want = swd.pre_sweep_reference(c.chans, c.tables, fetches=fetches, **c.kw)
    return want, fetches, lists


def dense_grad_case(device):
    """The dense autograd Function's seeded case on ``device``: a random
    20×24×28 volume in ``DENSE_BOX`` and the default TF (both requiring
    grad), a cotangent g (24, 40, 4), and the plan of a 32² camera at
    (0.3, 0.5, 1.2) over a (24, 40) grid with 24 planes, early exit off
    (so no ray's mask can flip between two devices).

    Returns (volume, tf, g, plan_args)."""
    from libre_tpu_torch.apps.render_cli import build_camera

    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.random((20, 24, 28), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((24, 40, 4)).astype(np.float32))
    camera, _frustum = build_camera(32, 32, (0.3, 0.5, 1.2), (0.0, 0.0, 0.0))
    params = RenderParams(n_samples_per_ray=24, data_source_range=(0.0, 1.0), early_exit=1.1)
    pa = swd.slope_grid_plan_args(
        sw.make_view_plan(camera), *DENSE_BOX, params,
        sw.ShearWarpParams(n_planes=24, inter_size=(24, 40)),
    )
    tf = torch.from_numpy(default_color_map())
    return (vol.to(device).requires_grad_(), tf.to(device).requires_grad_(),
            g.to(device), pa)


# ================================================================ sharding
# A sharded result against the one-device result on the same inputs
# (the JAX package's own bounds, tests/test_bricked_sharded.py and
# tests/test_store_slab_sharded.py): early exit off, the fold regroups
# floats; early exit on, termination is local to a shard's segment, so
# samples past the threshold enter scaled by < 1 − threshold.
SHARD_TOL_EXIT_OFF = 2e-5
SHARD_TOL_EXIT_ON = 2e-3
SHARD_LOSS_RTOL = 1e-6
SHARD_GRAD_TOL = 1e-5


def split_into_bricks(volume_zyx, n_split: int, overlap: int, device="cuda"):
    """Split a cubic (Z, Y, X) volume into n_split³ bricks of (b + 2·overlap)³
    f32 voxels, ghost voxels clamped at the border (the JAX tests'
    ``_split_into_bricks``) → a ``reference.BrickSet`` on ``device``:
    ``data.lod_store.brick_volume``."""
    from libre_tpu_torch.data.lod_store import brick_volume

    volume = np.asarray(volume_zyx, np.float32)
    return brick_volume(volume, volume.shape[2] // n_split, overlap, device=device)


# ============================================================ the TF lookup
TF_LOOKUP_SIZES = (1, 2, 32, 256, 4096, 8192)  # both sides of tf_lookup.cu's 4096
# The TF gradient summed in any f32 order against the float64 closed form:
# a share of the entry's sum of |contribution| (the rigorous bound of k terms
# in any order, (k − 1)·eps/2 of it, is vacuous at the dense trainer's 16.8M
# densities in two bins).  A lost run or block reads its share of that sum:
# on a few thousand densities in one bin a thread's run is 1e-3 of it or
# more, but on a flat 256³ volume (~60 densities a thread) a lost run is
# ~4e-6, under the bound, and only a lost block (~1e-3) shows; so the card's
# tests hold the kernel to both a small flat volume and the flat 256³.
TF_GRAD_RTOL = 1e-5
# The density gradient, N · Σ_c g_c (t1_c − t0_c): four products, three sums,
# four differences and the scale, in any order, within 8 eps of
# N · Σ_c |g_c| (|t0_c| + |t1_c|).
DENSITY_GRAD_EPS = 8


def tf_lookup_densities(n_tf: int, seed: int, size: int = 1000) -> torch.Tensor:
    """(size + edges,) f32 densities for the lookup's cases: 0 and 1, the
    texel centres (i + ½)/N of a few texels, the clamp edges ½/N and
    (N − ½)/N and their f32 neighbours, values outside [0, 1], the flat
    0.5, and ``size`` uniform draws over [−0.1, 1.1]."""
    rng = np.random.default_rng(seed)
    n = np.float32(n_tf)
    centres = (np.unique(rng.integers(0, n_tf, 8)).astype(np.float32) + np.float32(0.5)) / n
    edges = np.float32([0.5, n_tf - 0.5]) / n
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                            np.nextafter(edges, np.float32(2))])
    fixed = np.float32([0.0, 1.0, -0.0, -0.25, 1.5, -3.0, 7.0, 0.5, 0.5, 0.5])
    draws = rng.uniform(-0.1, 1.1, size).astype(np.float32)
    return torch.from_numpy(np.concatenate([fixed, centres, edges, draws]).astype(np.float32))


def lookup_backward_reference(tf: torch.Tensor, density: torch.Tensor, g: torch.Tensor):
    """The gradients of ``transfer_function.lookup_reference`` in closed
    form, as ``csrc/tf_lookup.cu``'s backward computes them: ``(d_tf,
    d_density)`` for the cotangent ``g`` (``density.shape + (4,)``).  With
    ``s' = clamp(d, 0, 1)·N − 0.5``, ``s = clamp(s', 0, N − 1)``, taps
    ``i0 = floor(s)``, ``i1 = min(i0 + 1, N − 1)`` and weight
    ``w = s − i0``: ``d_density = N · Σ_c g_c (tf[i1, c] − tf[i0, c])``
    where ``0 ≤ d ≤ 1`` and ``0 ≤ s' ≤ N − 1`` (``torch.clamp``'s backward
    passes the ends), else 0; ``d_tf[i0] += g (1 − w)``, ``d_tf[i1] += g w``.
    Computed in float64 from the float32 taps and weights, returned in
    ``tf``'s and ``density``'s dtypes."""
    n = tf.shape[0]
    s_pre = torch.clamp(density, 0.0, 1.0) * n - 0.5
    s = torch.clamp(s_pre, 0.0, float(n - 1))
    i0f = torch.floor(s)
    w = (s - i0f).reshape(-1, 1).double()
    i0 = i0f.long().reshape(-1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    g = g.reshape(-1, tf.shape[1]).double()
    t = tf.double()
    passes = (density >= 0.0) & (density <= 1.0) & (s_pre >= 0.0) & (s_pre <= n - 1)
    dot = (g * (t[i1] - t[i0])).sum(dim=1)
    d_density = torch.where(passes.reshape(-1), n * dot, 0.0).reshape(density.shape)
    d_tf = torch.zeros_like(t).index_add_(0, i0, g * (1.0 - w)).index_add_(0, i1, g * w)
    return d_tf.to(tf.dtype), d_density.to(density.dtype)


def tf_lookup_bounds(tf: torch.Tensor, density: torch.Tensor, g: torch.Tensor):
    """(d_tf, d_density) round-off bounds of the lookup's gradients
    (``TF_GRAD_RTOL``, ``DENSITY_GRAD_EPS``), in float64, per entry."""
    n = tf.shape[0]
    mass_tf, _ = lookup_backward_reference(tf.double(), density, g.abs())
    s = torch.clamp(torch.clamp(density, 0.0, 1.0) * n - 0.5, 0.0, float(n - 1))
    i0 = torch.floor(s).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    t = tf.double().abs()
    mass_d = (g.double().abs() * (t[i0] + t[i1])).sum(dim=-1)
    eps = torch.finfo(torch.float32).eps
    return TF_GRAD_RTOL * mass_tf, DENSITY_GRAD_EPS * eps * n * mass_d


def assert_tf_lookup_grads(got, want, bounds, what):
    """Raises unless each of ``got`` (d_tf, d_density; None where not
    asked for) lies within its bound of ``want``'s."""
    for name, a, b, bound in zip(("d_tf", "d_density"), got, want, bounds):
        if a is None:
            continue
        err = (a.double() - b.double()).abs()
        over = err > bound
        if bool(over.any()):
            i = int(torch.argmax((err - bound).reshape(-1)))
            raise AssertionError(
                f"{what}: {name} off by {float(err.reshape(-1)[i])} against a bound of "
                f"{float(bound.reshape(-1)[i])} at flat index {i} ({int(over.sum())} entries)")
