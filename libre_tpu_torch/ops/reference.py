"""Shared render types and the per-sample oracle marcher
(``libre_tpu.ops.reference``).

The constants and types both render paths need: the early-exit threshold
and alpha clamp of fragRaycast.glsl:104-117, the GL camera triple, the
static marching parameters and the Nyquist sample count.  And the
port's own per-sample oracle, :func:`render_reference`, eager PyTorch,
op for op the reference per-ray loop (fragRaycast.glsl:113-215 and
cuda Renderer.cu:95-230):

  * window→eye→world unprojection, ray through each pixel,
  * ray/AABB slab intersection for the global volume box and each brick,
  * eye-space near-plane clamp,
  * the global sample grid ``t_n = tnGlobal + n·step`` shared by every
    brick (fragRaycast.glsl:152-158) with half-open (t0, t1] ownership,
  * clip-plane interval clamping,
  * point-sampled (GL_NEAREST) or trilinear density fetch, normalized by
    the data-source range (fragRaycast.glsl:188-203),
  * linear-filtered 256-entry transfer-function lookup,
  * front-to-back compositing with opacity correction
    ``alpha = 1 - (1 - min(a, 1 - 1/256))^(maxSamples/nSamples)`` and
    early termination at alpha > 0.999, as masks, one sample at a time.

It is slow (a Python loop over the samples of every brick) and only
serves the tests; the exact marcher's plain version is
``ops/raycast.py`` and its kernel ``ops/exact.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.transfer_function import lookup

EARLY_EXIT = 0.999
ALPHA_CLAMP = 1.0 - 1.0 / 256.0
MAX_SAMPLES_PER_RAY = 32  # opacity-correction reference count (GLRaycastRenderer.cpp:75)
MIN_SAMPLES_PER_RAY = 512


class BrickSet(NamedTuple):
    """A stack of same-shape padded bricks plus placement metadata.

    ``data``: (N, BZ, BY, BX) raw densities (padded with ghost voxels);
    ``world_min/max``: (N, 3) f32 world AABBs of the brick *interior*;
    ``tex_min/max``: (N, 3) f32 normalized coordinates of the interior
    box within the padded brick (TextureObject.cpp:79-128).
    """

    data: torch.Tensor
    world_min: torch.Tensor
    world_max: torch.Tensor
    tex_min: torch.Tensor
    tex_max: torch.Tensor

    @property
    def num_bricks(self) -> int:
        return self.data.shape[0]


class Camera(NamedTuple):
    """GL-style camera: modelview/projection pair plus viewport."""

    inv_proj: np.ndarray  # (4, 4)
    inv_mv: np.ndarray  # (4, 4)
    viewport: Tuple[int, int, int, int]  # (x, y, w, h)
    near: float  # near-plane distance (Frustum::nearPlane())


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Static marching parameters (RendererParameters defaults,
    rendererParameters.fbs:3-12).  The bricked path reads the sample
    counts, the data range and the early exit; the exact marcher also
    reads the filter mode and the samples per pixel."""

    n_samples_per_ray: int = MIN_SAMPLES_PER_RAY
    samples_per_pixel: int = 1
    max_samples_per_ray: int = MAX_SAMPLES_PER_RAY
    data_source_range: Tuple[float, float] = (0.0, 255.0)
    early_exit: float = EARLY_EXIT
    filter_mode: str = "nearest"  # "nearest" (reference parity) | "trilinear"
    max_steps_per_brick: Optional[int] = None  # render_reference's march length

    @property
    def step_size(self) -> float:
        return 1.0 / float(self.n_samples_per_ray)

    @property
    def alpha_correction(self) -> float:
        return float(self.max_samples_per_ray) / float(self.n_samples_per_ray)


def nyquist_samples_per_ray(
    voxels: Tuple[int, int, int], tree_depth: int, max_rendered_level: int
) -> int:
    """Auto sample count: Nyquist from the finest rendered LOD, min 512
    (GLRaycastRenderer.cpp:232-248)."""
    max_voxel_dim = float(max(voxels))
    max_voxels_at_lod = max_voxel_dim / float(1 << (tree_depth - max_rendered_level - 1))
    return int(max(max_voxels_at_lod, MIN_SAMPLES_PER_RAY))


def max_steps_for_bricks(
    world_min: np.ndarray, world_max: np.ndarray, step_size: float
) -> int:
    """Bound on per-brick march length: brick diagonal / step."""
    diag = np.linalg.norm(np.asarray(world_max) - np.asarray(world_min), axis=-1)
    return int(math.ceil(float(np.max(diag)) / step_size)) + 4


def single_brick_set(
    volume_zyx,
    overlap: Tuple[int, int, int] = (0, 0, 0),
    world_min: Tuple[float, float, float] = (-0.5, -0.5, -0.5),
    world_max: Tuple[float, float, float] = (0.5, 0.5, 0.5),
) -> BrickSet:
    """Wrap one whole (Z, Y, X) volume as a single brick (configs 1-2;
    raw:// datasource semantics, RawDataSource.cpp:78-88)."""
    vol = torch.as_tensor(volume_zyx)[None]
    dev = vol.device
    bz, by, bx = vol.shape[1:]
    ox, oy, oz = overlap
    padded = torch.tensor([bx, by, bz], dtype=torch.float32, device=dev)
    inset = torch.tensor([[ox, oy, oz]], dtype=torch.float32, device=dev)
    return BrickSet(
        data=vol,
        world_min=torch.tensor([world_min], dtype=torch.float32, device=dev),
        world_max=torch.tensor([world_max], dtype=torch.float32, device=dev),
        tex_min=inset / padded,
        tex_max=(padded - inset) / padded,
    )


def sample_density(
    brick: torch.Tensor, tex_pos: torch.Tensor, filter_mode: str
) -> torch.Tensor:
    """Fetch f32 density from a padded (Z, Y, X) brick at normalized
    coords (..., 3), axes (x, y, z).  ``nearest`` matches the reference's
    GL_NEAREST 3-D textures; ``trilinear`` treats voxel centers at
    (i + 0.5)/dim with clamp-to-edge."""
    bz, by, bx = brick.shape
    brick = brick.float()
    dev = brick.device
    dims = torch.tensor([bx, by, bz], dtype=torch.float32, device=dev)
    top = torch.tensor([bx - 1, by - 1, bz - 1], dtype=torch.int64, device=dev)
    if filter_mode == "nearest":
        idx = torch.minimum(torch.floor(tex_pos * dims).long().clamp(min=0), top)
        return brick[idx[..., 2], idx[..., 1], idx[..., 0]]
    if filter_mode == "trilinear":
        s = torch.minimum(torch.clamp(tex_pos * dims - 0.5, min=0.0), dims - 1.0)
        i0 = torch.floor(s).long()
        i1 = torch.minimum(i0 + 1, top)
        w = s - torch.floor(s)

        def fetch(ix, iy, iz):
            return brick[iz, iy, ix]

        c000 = fetch(i0[..., 0], i0[..., 1], i0[..., 2])
        c100 = fetch(i1[..., 0], i0[..., 1], i0[..., 2])
        c010 = fetch(i0[..., 0], i1[..., 1], i0[..., 2])
        c110 = fetch(i1[..., 0], i1[..., 1], i0[..., 2])
        c001 = fetch(i0[..., 0], i0[..., 1], i1[..., 2])
        c101 = fetch(i1[..., 0], i0[..., 1], i1[..., 2])
        c011 = fetch(i0[..., 0], i1[..., 1], i1[..., 2])
        c111 = fetch(i1[..., 0], i1[..., 1], i1[..., 2])
        wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
        c00 = c000 * (1 - wx) + c100 * wx
        c10 = c010 * (1 - wx) + c110 * wx
        c01 = c001 * (1 - wx) + c101 * wx
        c11 = c011 * (1 - wx) + c111 * wx
        c0 = c00 * (1 - wy) + c10 * wy
        c1 = c01 * (1 - wy) + c11 * wy
        return c0 * (1 - wz) + c1 * wz
    raise ValueError(f"unknown filter mode {filter_mode!r}")


def composite(
    src: torch.Tensor, dst_rgb: torch.Tensor, dst_a: torch.Tensor,
    alpha_correction: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back over-composite with opacity correction
    (fragRaycast.glsl:104-111)."""
    alpha = 1.0 - torch.pow(
        1.0 - torch.clamp(src[..., 3], max=ALPHA_CLAMP), alpha_correction
    )
    one_minus = 1.0 - dst_a
    dst_rgb = dst_rgb + src[..., :3] * (alpha * one_minus)[..., None]
    dst_a = dst_a + alpha * one_minus
    return dst_rgb, dst_a


def _march_one_brick(
    rgb, a, brick, wmin, wmax, tmin, tmax, eye, dirs, t_near_plane,
    tn_global, hit_global, tf, clip_bounds, params: RenderParams,
    max_steps: int,
):
    """Composite one brick's ray segments onto the carried (rgb, a)."""
    step = params.step_size
    lo, hi = params.data_source_range
    mult = 1.0 / (hi - lo)
    add = -lo / (hi - lo)

    t0, t1, hit = ray_ops.intersect_box(eye, dirs, wmin, wmax)
    tnear = torch.maximum(t0, t_near_plane)
    n0 = torch.floor((tnear - tn_global) / step).to(torch.int32) - 1
    # Samples before the near plane are excluded globally
    # (fragRaycast.glsl:149-150): first admissible grid index.
    n_start = torch.ceil(
        torch.clamp(t_near_plane - tn_global, min=0.0) / step
    ).to(torch.int32)
    valid = hit & hit_global
    tex_scale = tmax - tmin

    for k in range(max_steps):
        n = n0 + k
        t = tn_global + n.to(torch.float32) * step
        # Early exit checked before compositing the next sample
        # (fragRaycast.glsl:115-117, 208-209); half-open (t0, t1]
        # ownership (see ops/raycast.py).
        m = valid & (n >= n_start) & (a <= params.early_exit)
        if clip_bounds is not None:
            m = m & (t > clip_bounds[0]) & (t <= clip_bounds[1])
        m = m & (t > t0) & (t <= t1)
        pos = eye + dirs * t[..., None]
        u = (pos - wmin) / (wmax - wmin)
        tex_pos = u * tex_scale + tmin
        raw = sample_density(brick, tex_pos, params.filter_mode)
        density = torch.clamp(raw * mult + add, 0.0, 1.0)
        src = lookup(tf, density)
        new_rgb, new_a = composite(src, rgb, a, params.alpha_correction)
        rgb = torch.where(m[..., None], new_rgb, rgb)
        a = torch.where(m, new_a, a)
    return rgb, a


def render_reference(
    bricks: BrickSet,
    tf: torch.Tensor,
    camera: Camera,
    params: RenderParams,
    global_min,
    global_max,
    clip_planes: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Render a brick set to an (H, W, 4) image (bottom-up row order), on
    the device of ``bricks.data``.

    Bricks are marched in front-to-back order, sorted (stably) by the
    distance of the brick center to the eye (GLRaycastRenderer's
    DistanceOperator, GLRaycastPipeline.cpp:106-126).  Jittered samples
    (``samples_per_pixel`` > 1) take their fragment coords from
    ``rays.jitter_frag``.
    """
    vx, vy, vw, vh = camera.viewport
    dev = bricks.data.device
    tf = tf.to(dev)
    step = params.step_size
    if params.max_steps_per_brick is not None:
        max_steps = params.max_steps_per_brick
    else:
        max_steps = max_steps_for_bricks(
            bricks.world_min.cpu().numpy(), bricks.world_max.cpu().numpy(), step
        )

    images = []
    for s in range(params.samples_per_pixel):
        eye, dirs, cos_z, _ = ray_ops.make_rays(
            camera.inv_proj, camera.inv_mv, camera.viewport, sample_index=s,
            device=dev,
        )
        dirs = dirs.reshape(-1, 3)
        t_near_plane = ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
        tn_global, _, hit_global = ray_ops.intersect_box(
            eye, dirs, global_min, global_max
        )
        clip_bounds = None
        if clip_planes is not None and len(clip_planes) > 0:
            full = torch.full_like(tn_global, 3e38)
            clip_bounds = ray_ops.clip_ray(eye, dirs, -full, full, clip_planes)

        centers = (bricks.world_min + bricks.world_max) * 0.5
        dist = torch.linalg.norm(centers - eye, dim=-1)
        order = torch.argsort(dist, stable=True).tolist()

        rgb = torch.zeros((dirs.shape[0], 3), device=dev)
        a = torch.zeros((dirs.shape[0],), device=dev)
        for i in order:
            rgb, a = _march_one_brick(
                rgb, a, bricks.data[i], bricks.world_min[i],
                bricks.world_max[i], bricks.tex_min[i], bricks.tex_max[i],
                eye, dirs, t_near_plane, tn_global, hit_global, tf,
                clip_bounds, params, max_steps,
            )
        images.append(torch.cat([rgb, a[..., None]], dim=-1))

    img = sum(images) / float(params.samples_per_pixel)
    return img.reshape(vh, vw, 4)
