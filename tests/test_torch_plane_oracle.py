"""The port's ``shearwarp.plane_oracle`` against the JAX package's, on the
same seeded numpy inputs: "pre" and "post" classification, the SENTINEL
mask over a volume with uncovered voxels, and clip planes, within 1e-5;
the port's plain pipeline ``render_slope_grid`` against the port's oracle
on the slope-grid rays (2e-5, as tests/test_shearwarp.py holds the JAX
pair); and autograd of the port's oracle against ``jax.grad`` of the JAX
one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as RenderParamsJ
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops.reference import RenderParams as RenderParamsT
from tests.test_reference_marcher import make_volume
from tests.test_torch_exact import cameras

torch.set_num_threads(1)

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)
K = 48
GRID = (24, 20)
TOL = 1e-5
PARAMS = dict(n_samples_per_ray=64, data_source_range=(0.0, 1.0), filter_mode="trilinear")
CLIP = np.float32([[0.0, 0.0, 1.0, 0.2], [1.0, 0.3, 0.0, 0.25]])
SENTINEL = -1.0

CASES = {
    # name: (classification, eye, clip planes, sentinel mask)
    "pre": ("pre", [0.2, 0.1, 1.4], None, False),
    "post": ("post", [0.2, 0.1, 1.4], None, False),
    "post_x": ("post", [1.4, 0.2, 0.1], None, False),
    "pre_clip": ("pre", [0.2, 0.1, 1.4], CLIP, False),
    "post_clip": ("post", [0.1, -1.5, 0.2], CLIP, False),
    "sentinel": ("post", [0.2, 0.1, 1.4], None, True),
}


def scene(sentinel):
    """(volume, TF); with ``sentinel`` the volume has uncovered voxels (a
    corner block and a slab) and the TF is opaque at density 0, so that a
    sample the mask keeps there shows."""
    vol = make_volume(32, seed=3)
    tf = tf_j.default_color_map(64)
    if sentinel:
        vol[:12, :12, :12] = SENTINEL
        vol[:, 20:24, :] = SENTINEL
        tf = (0.2 + 0.8 * tf).astype(np.float32)
    return vol, tf


def slope_rays(eye):
    """The view's plan and the (U·V,) slopes of its slope grid, in numpy."""
    cam_j, _ = cameras(eye, img=32)
    plan = sw_j.make_plan(cam_j)
    u0, u1, v0, v1 = plan.bounds
    uu, vv = np.meshgrid(np.linspace(u0, u1, GRID[1], dtype=np.float32),
                         np.linspace(v0, v1, GRID[0], dtype=np.float32), indexing="xy")
    return plan, uu.reshape(-1), vv.reshape(-1)


def both(case, vol, tf):
    classification, eye, clip, sentinel = CASES[case]
    plan, uu, vv = slope_rays(eye)
    kw = dict(classification=classification, clip_planes_world=clip, sentinel_mask=sentinel)
    want = sw_j.plane_oracle(
        jnp.asarray(vol), jnp.asarray(tf), plan.eye, plan.axis, plan.sign,
        (jnp.asarray(uu), jnp.asarray(vv)), GMIN, GMAX, RenderParamsJ(**PARAMS), K, **kw)
    got = sw_t.plane_oracle(
        torch.from_numpy(vol), torch.from_numpy(tf), plan.eye, plan.axis, plan.sign,
        (torch.from_numpy(uu), torch.from_numpy(vv)), GMIN, GMAX, RenderParamsT(**PARAMS), K,
        **kw)
    return plan, got, np.asarray(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_oracle_matches_jax(case):
    vol, tf = scene(CASES[case][3])
    _plan, got, want = both(case, vol, tf)
    assert got.shape == (GRID[0] * GRID[1], 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert want[:, 3].max() > 0.1


def test_sentinel_and_clip_drop_samples():
    """The mask and the planes change the image (so the cases above test
    them), and a sentinel volume without the mask is another image."""
    vol, tf = scene(True)
    _plan, masked, _ = both("sentinel", vol, tf)
    _plan, unmasked, _ = both("post", vol, tf)
    assert float((masked - unmasked).abs().max()) > 1e-2
    vol, tf = scene(False)
    _plan, clipped, _ = both("pre_clip", vol, tf)
    _plan, whole, _ = both("pre", vol, tf)
    assert float((clipped - whole).abs().max()) > 1e-2


@pytest.mark.parametrize("classification", ["pre", "post"])
def test_slope_grid_matches_port_oracle(classification):
    """The port's plain matrix pipeline on its slope grid == the port's
    oracle on the same rays (tests/test_shearwarp.py's 2e-5)."""
    vol, tf = scene(False)
    _, cam_t = cameras([0.2, 0.1, 1.4], img=32)
    plan = sw_t.make_plan(cam_t)
    params = RenderParamsT(**PARAMS)
    swp = sw_t.ShearWarpParams(n_planes=K, inter_size=GRID, classification=classification)
    v, t = torch.from_numpy(vol), torch.from_numpy(tf)
    inter, ug, vg = sw_t.render_slope_grid(
        v, t, plan.eye, plan.axis, plan.sign, plan.bounds, GMIN, GMAX, params, swp)
    vv, uu = torch.meshgrid(vg, ug, indexing="ij")
    oracle = sw_t.plane_oracle(
        v, t, plan.eye, plan.axis, plan.sign, (uu.reshape(-1), vv.reshape(-1)),
        GMIN, GMAX, params, K, classification=classification).reshape(inter.shape)
    np.testing.assert_allclose(inter.numpy(), oracle.numpy(), rtol=0, atol=2e-5)


def test_oracle_gradient_matches_jax():
    """Autograd of the port's oracle vs ``jax.grad`` of the JAX one
    ("post", clip planes, early exit off), normalised by the largest
    entry, within 1e-4."""
    vol, tf = scene(False)
    plan, uu, vv = slope_rays([0.2, 0.1, 1.4])
    p = dict(PARAMS, early_exit=1.1)
    rng = np.random.default_rng(0)
    g = rng.random((uu.size, 4), dtype=np.float32)
    kw = dict(classification="post", clip_planes_world=CLIP)

    def loss_j(v, t):
        out = sw_j.plane_oracle(v, t, plan.eye, plan.axis, plan.sign,
                                (jnp.asarray(uu), jnp.asarray(vv)), GMIN, GMAX,
                                RenderParamsJ(**p), K, **kw)
        return jnp.sum(out * g)

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))
    v = torch.from_numpy(vol).requires_grad_()
    t = torch.from_numpy(tf).requires_grad_()
    out = sw_t.plane_oracle(v, t, plan.eye, plan.axis, plan.sign,
                            (torch.from_numpy(uu), torch.from_numpy(vv)), GMIN, GMAX,
                            RenderParamsT(**p), K, **kw)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in ((v.grad, want[0]), (t.grad, want[1])):
        w = np.asarray(w)
        scale = np.abs(w).max()
        assert scale > 0
        assert np.abs(got.numpy() - w).max() / scale <= 1e-4
