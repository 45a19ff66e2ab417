"""The port's exact marcher against the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages:

* ``ops/rays`` (ray generation, slab test, clip interval) vs
  ``libre_tpu.ops.rays``: atol 1e-6, the 4×4 matmuls of the
  unprojection accumulate in another order (a few ulps);
* the port's oracle ``reference.render_reference`` vs the JAX one;
* the port's plain marcher (``raycast.render`` and ``exact.render_exact``,
  which on the CPU runs ``march_exact_reference``) vs JAX
  ``raycast.render`` and ``exact_pallas.render_exact`` in interpret mode.

Image tolerances start from the JAX suite's own 1e-4
(tests/test_exact_pallas.py:29) and are tightened to 1e-5, which holds
against the JAX oracle, its gather marcher and the Pallas kernel alike:
the sample math is the same f32 arithmetic, and only sums (the
composite, the unprojection matmuls, the kernel's interpolation) run in
another order (largest difference seen: 2.1e-6, the clip-plane case).
Jittered subpixel samples (spp = 2) hand both packages the same
fragment grid (``rays.jitter_frag``): an ulp of ``sin`` in ``glsl_rand``
moves the jitter visibly, and the two libraries' ``sin`` differ.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import look_at, perspective
from libre_tpu.ops import exact_pallas as ep_j
from libre_tpu.ops import rays as rays_j
from libre_tpu.ops import raycast as raycast_j
from libre_tpu.ops import reference as ref_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import rays as rays_t
from libre_tpu_torch.ops import raycast as raycast_t
from libre_tpu_torch.ops import reference as ref_t
from libre_tpu_torch.testing import exact_case

torch.set_num_threads(1)

GMIN = np.float32([-0.5, -0.5, -0.5])
GMAX = np.float32([0.5, 0.5, 0.5])
ATOL = 1e-5


def cameras(eye, img=32, near=0.1, far=15.0, fov=50.0):
    proj = perspective(fov, 1.0, near, far)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=near,
    )
    return ref_j.Camera(**kw), ref_t.Camera(**kw)


def scene(n=32, spr=64, filter_mode="trilinear", seed=0, **extra):
    """(volume (n³) f32, default TF, JAX params, port params)."""
    rng = np.random.default_rng(seed)
    vol = rng.random((n, n, n), dtype=np.float32)
    tf = tf_j.default_color_map(256)
    kw = dict(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode=filter_mode,
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * spr)) + 4, **extra,
    )
    return vol, tf, ref_j.RenderParams(**kw), ref_t.RenderParams(**kw)


def shared_jitter(monkeypatch):
    """Make the JAX package's ray builder take the port's jitter grid."""
    make_rays = rays_j.make_rays

    def patched(inv_proj, inv_mv, viewport, sample_index=0, frag_override=None):
        if sample_index > 0 and frag_override is None:
            frag_override = rays_t.jitter_frag(tuple(viewport), sample_index)
        return make_rays(inv_proj, inv_mv, viewport, sample_index, frag_override)

    monkeypatch.setattr(rays_j, "make_rays", patched)


EYES = {
    "head_on": [0.2, 0.1, 1.4],
    "x_axis": [1.4, 0.1, 0.2],
    "y_axis": [0.1, 1.4, -0.2],
    "negative": [-0.2, -1.35, 0.3],
}


@pytest.mark.parametrize("sample_index", [0, 1])
@pytest.mark.parametrize("eye", sorted(EYES))
def test_make_rays_matches_jax(eye, sample_index):
    cam_j, cam_t = cameras(EYES[eye], img=24)
    frag = rays_t.jitter_frag(cam_t.viewport, sample_index) if sample_index else None
    want = rays_j.make_rays(
        cam_j.inv_proj, cam_j.inv_mv, cam_j.viewport, frag_override=frag
    )
    got = rays_t.make_rays(
        cam_t.inv_proj, cam_t.inv_mv, cam_t.viewport, frag_override=frag, device="cpu"
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        rays_t.near_plane_t(got[2], cam_t.near).numpy(),
        np.asarray(rays_j.near_plane_t(want[2], cam_j.near)), rtol=1e-6,
    )
    img = got[1]
    np.testing.assert_array_equal(rays_t.flip_image(img).numpy(), img.numpy()[::-1])


def test_intersect_box_and_clip_ray_match_jax():
    """Seeded rays, a third of their direction components exactly 0 (the
    eps nudge of rays.py:101), against a brick box and two clip planes:
    the same floats (single IEEE ops in the same order)."""
    rng = np.random.default_rng(0)
    origin = np.float32([0.3, -0.2, 1.4])
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs[rng.random((500, 3)) < 0.33] = 0.0
    bmin, bmax = np.float32([-0.25, -0.5, 0.0]), np.float32([0.25, 0.0, 0.5])
    want = rays_j.intersect_box(jnp.asarray(origin), jnp.asarray(dirs), bmin, bmax)
    got = rays_t.intersect_box(torch.from_numpy(origin), torch.from_numpy(dirs), bmin, bmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    planes = np.float32([[1.0, 0.0, 0.0, 0.1], [0.0, -0.6, 0.8, 0.2]])
    lo, hi = np.full(500, -3e38, np.float32), np.full(500, 3e38, np.float32)
    want = rays_j.clip_ray(jnp.asarray(origin), jnp.asarray(dirs), lo, hi, planes)
    got = rays_t.clip_ray(
        torch.from_numpy(origin), torch.from_numpy(dirs), torch.from_numpy(lo),
        torch.from_numpy(hi), planes,
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


ORACLE_CASES = {
    # name: (filter mode, eye, clip planes, extra params, opaque TF)
    "nearest": ("nearest", "head_on", None, {}, False),
    "trilinear_x_axis": ("trilinear", "x_axis", None, {}, False),
    "clip_planes": (
        "trilinear", "head_on",
        np.float32([[0.0, 0.0, 1.0, 0.2], [1.0, 0.0, 0.0, 0.3]]), {}, False,
    ),
    "early_exit": ("nearest", "negative", None, {}, True),
    "spp2": ("trilinear", "head_on", None, {"samples_per_pixel": 2}, False),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_render_reference_matches_jax(monkeypatch, case):
    """The port's per-sample oracle vs the JAX oracle (16³, 16², 32
    samples per ray)."""
    filter_mode, eye, clip, extra, opaque = ORACLE_CASES[case]
    vol, tf, p_j, p_t = scene(n=16, spr=32, filter_mode=filter_mode, **extra)
    if opaque:
        tf = np.ones((256, 4), np.float32)
    shared_jitter(monkeypatch)
    cam_j, cam_t = cameras(EYES[eye], img=16)
    want = np.asarray(ref_j.render_reference(
        ref_j.single_brick_set(jnp.asarray(vol)), jnp.asarray(tf), cam_j, p_j,
        GMIN, GMAX, clip_planes=clip,
    ))
    got = ref_t.render_reference(
        ref_t.single_brick_set(torch.from_numpy(vol)), torch.from_numpy(tf),
        cam_t, p_t, GMIN, GMAX, clip_planes=clip,
    )
    assert got.shape == (16, 16, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert want[..., 3].max() > (0.999 if opaque else 0.1)


MARCH_CASES = {
    # name: (filter mode, eye, clip planes, opaque TF)
    "trilinear_head_on": ("trilinear", "head_on", None, False),
    "nearest_head_on": ("nearest", "head_on", None, False),
    "trilinear_x_axis": ("trilinear", "x_axis", None, False),
    "trilinear_negative": ("trilinear", "negative", None, False),
    "clip_planes": (
        "trilinear", "head_on",
        np.float32([[0.0, 0.0, 1.0, 0.2], [1.0, 0.0, 0.0, 0.3]]), False,
    ),
    "early_exit": ("trilinear", "head_on", None, True),
}


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_plain_marcher_matches_jax(case):
    """The port's plain marcher (``raycast.render``; ``exact.render_exact``
    on the CPU) vs JAX ``raycast.render`` and ``exact_pallas.render_exact``
    (interpret mode) on the JAX suite's 32³ / 32² / 64-sample scene."""
    filter_mode, eye, clip, opaque = MARCH_CASES[case]
    vol, tf, p_j, p_t = scene(filter_mode=filter_mode)
    if opaque:
        tf = np.ones((256, 4), np.float32)
    cam_j, cam_t = cameras(EYES[eye])
    vol_t, tf_t = torch.from_numpy(vol), torch.from_numpy(tf)
    want_xla = np.asarray(raycast_j.render(
        ref_j.single_brick_set(jnp.asarray(vol)), jnp.asarray(tf), cam_j, p_j,
        GMIN, GMAX, clip_planes=clip,
    ))
    want_pallas = np.asarray(ep_j.render_exact(
        jnp.asarray(vol), jnp.asarray(tf), cam_j, p_j, clip_planes=clip,
        interpret=True,
    ))
    got = raycast_t.render(
        ref_t.single_brick_set(vol_t), tf_t, cam_t, p_t, GMIN, GMAX,
        clip_planes=clip,
    )
    launches = exact.march_exact.launches
    got_exact = exact.render_exact(vol_t, tf_t, cam_t, p_t, clip_planes=clip)
    assert exact.march_exact.launches == launches  # the CPU runs no kernel
    np.testing.assert_array_equal(got_exact.numpy(), got.numpy())
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=0, atol=ATOL)
    assert want_xla[..., 3].max() > (0.999 if opaque else 0.1)


def test_multi_brick_carry_matches_jax():
    """Two half-volume bricks marched front to back, the carry passed
    between them: per brick ``exact.render_exact_rays`` vs the JAX
    kernel's, and the two-brick ``raycast.render_rays`` vs the JAX one."""
    vol, tf, p_j, p_t = scene(n=16, spr=32)
    cam_j, cam_t = cameras(EYES["head_on"], img=16)
    halves = [vol[:8], vol[8:]]
    boxes = [
        (np.float32([-0.5, -0.5, -0.5]), np.float32([0.5, 0.5, 0.0])),
        (np.float32([-0.5, -0.5, 0.0]), np.float32([0.5, 0.5, 0.5])),
    ]
    carry_j = carry_t = None
    for i in (1, 0):  # near (z > 0) half first for an eye at z = +1.4
        wmin, wmax = boxes[i]
        plan = ep_j.plan_exact(
            cam_j, p_j, wmin, wmax, halves[i].shape, global_min=GMIN, global_max=GMAX
        )
        carry_j = ep_j.render_exact_rays(
            jnp.asarray(halves[i]), jnp.asarray(tf), plan, init_carry=carry_j,
            interpret=True,
        )
        carry_t = exact.render_exact_rays(
            torch.from_numpy(halves[i]), torch.from_numpy(tf), cam_t, p_t,
            world_min=wmin, world_max=wmax, global_min=GMIN, global_max=GMAX,
            init_carry=carry_t,
        )
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j), rtol=0, atol=ATOL)
    assert float(carry_t[:, 3].max()) > 0.1

    eye_j, dirs_j, cos_j, _ = rays_j.make_rays(cam_j.inv_proj, cam_j.inv_mv, cam_j.viewport)
    eye_t, dirs_t, cos_t, _ = rays_t.make_rays(
        cam_t.inv_proj, cam_t.inv_mv, cam_t.viewport, device="cpu"
    )
    wmin = np.stack([b[0] for b in boxes])
    wmax = np.stack([b[1] for b in boxes])
    order = raycast_t.sort_bricks_front_to_back(wmin, wmax, np.asarray(eye_t))
    assert list(order) == [1, 0]
    bricks = dict(world_min=wmin, world_max=wmax, tex_min=np.zeros((2, 3), np.float32),
                  tex_max=np.ones((2, 3), np.float32))
    want = raycast_j.render_rays(
        ref_j.BrickSet(data=jnp.asarray(np.stack(halves)),
                       **{k: jnp.asarray(v) for k, v in bricks.items()}),
        jnp.asarray(tf), eye_j, dirs_j.reshape(-1, 3),
        rays_j.near_plane_t(cos_j.reshape(-1), cam_j.near), p_j, GMIN, GMAX,
        brick_order=order,
    )
    got = raycast_t.render_rays(
        ref_t.BrickSet(data=torch.from_numpy(np.stack(halves)),
                       **{k: torch.from_numpy(v) for k, v in bricks.items()}),
        torch.from_numpy(tf), eye_t, dirs_t.reshape(-1, 3),
        rays_t.near_plane_t(cos_t.reshape(-1), cam_t.near), p_t, GMIN, GMAX,
        brick_order=order,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), carry_t.numpy(), rtol=0, atol=ATOL)


def test_multi_sample_matches_jax(monkeypatch):
    """spp = 2, both packages on the port's jitter grid: the plain marcher
    vs JAX ``raycast.render`` and the JAX oracle."""
    shared_jitter(monkeypatch)
    vol, tf, p_j, p_t = scene(n=16, spr=32, samples_per_pixel=2)
    cam_j, cam_t = cameras(EYES["head_on"], img=16)
    want = np.asarray(raycast_j.render(
        ref_j.single_brick_set(jnp.asarray(vol)), jnp.asarray(tf), cam_j, p_j,
        GMIN, GMAX,
    ))
    oracle = np.asarray(ref_j.render_reference(
        ref_j.single_brick_set(jnp.asarray(vol)), jnp.asarray(tf), cam_j, p_j,
        GMIN, GMAX,
    ))
    got = exact.render_exact(torch.from_numpy(vol), torch.from_numpy(tf), cam_t, p_t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=ATOL)
    single = exact.render_exact(
        torch.from_numpy(vol), torch.from_numpy(tf), cam_t,
        dataclasses.replace(p_t, samples_per_pixel=1),
    )
    assert float((got - single).abs().max()) > 0  # the jitter moved rays


def test_sample_counts_tile_the_volume():
    """Half-open (t0, t1] ownership: over the seeded 4×4×4-brick case with
    the early exit off, every ray composites exactly the global-grid
    samples inside the global box, its clip interval and past its near
    plane, once, whichever brick owns them; ``used`` flags exactly the
    bricks that took a sample."""
    c = exact_case("bricks", seed=0, device="cpu", filter_mode="nearest")
    params = dataclasses.replace(c.params, early_exit=1.1)
    n_rays = c.carry.shape[0]
    samples = torch.zeros(n_rays, dtype=torch.int32)
    used = torch.zeros(c.slots.shape[0], dtype=torch.int32)
    exact.march_exact(
        c.atlas, c.slots, c.boxes, c.tf, c.rays, torch.zeros_like(c.carry),
        c.eye, params, max_steps=c.max_steps, samples=samples, used=used,
    )
    dx, dy, dz, tnp, tng, n_start, t_lo, t_hi = c.rays
    dirs = torch.stack([dx, dy, dz], dim=-1)
    t0, t1, _ = rays_t.intersect_box(torch.from_numpy(c.eye), dirs, GMIN, GMAX)
    lo, hi = torch.maximum(t0, t_lo), torch.minimum(t1, t_hi)
    n = torch.arange(-2, 1200, dtype=torch.int32)[None, :]
    t = tng[:, None] + n.to(torch.float32) * params.step_size
    want = ((t > lo[:, None]) & (t <= hi[:, None]) & (n >= n_start[:, None].int())).sum(1)
    np.testing.assert_array_equal(samples.numpy(), want.int().numpy())
    assert int(samples.sum()) > 0 and 0 < int(used.sum()) < used.numel()


def test_march_exact_rejects_bad_operands():
    c = exact_case("bricks", seed=1, device="cpu")
    args = [c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params]
    kw = dict(max_steps=c.max_steps)
    bad = [
        (1, c.slots.long(), TypeError),  # slots must be int32
        (2, c.boxes[:, :12].contiguous(), ValueError),  # (B, 16) boxes
        (4, c.rays.t(), ValueError),  # (8, R), contiguous
        (5, c.carry.double(), TypeError),
    ]
    for i, value, err in bad:
        wrong = list(args)
        wrong[i] = value
        with pytest.raises(err):
            exact.march_exact(*wrong, **kw)
    with pytest.raises(ValueError, match="filter"):
        exact.march_exact(*args[:7], dataclasses.replace(c.params, filter_mode="cubic"), **kw)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        exact.march_exact(*meta, **kw)
