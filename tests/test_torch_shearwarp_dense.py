"""The port's dense pre-classified shear-warp (libre_tpu_torch.ops.
shearwarp_dense and the plain pipeline of ops/shearwarp) against the JAX
package's ``shearwarp_pallas`` (its Pallas kernel in interpret mode) and
``shearwarp``, on the CPU.

The scene is tests/test_shearwarp_pallas.py's: a 20×24×28 volume in a
non-cubic box, a (24, 40) slope grid, 24 planes, four eyes covering every
major axis and both marching signs.  Tolerances: classification 1e-6
(one lerp, rounded in another order), frames 2e-5 (the bound the JAX
package holds its own kernel to against its jnp pipeline), gradients
1e-6 absolute on a mean loss and 2e-5 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import look_at, perspective
from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_pallas as swp_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.testing import DENSE_BOX, DENSE_EYES as EYES

torch.set_num_threads(1)

GMIN, GMAX = DENSE_BOX
PARAMS = dict(n_samples_per_ray=24, data_source_range=(0.0, 1.0), filter_mode="trilinear")
SWP = dict(n_planes=24, inter_size=(24, 40))


def cameras(eye, img=32):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at(eye, [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img), near=0.1,
    )
    return CameraJ(**kw), CameraT(**kw)


def random_scene():
    rng = np.random.default_rng(0)
    return rng.random((20, 24, 28), dtype=np.float32), tf_j.default_color_map(64)


def sparse_scene():
    """Content in a central block only, and alpha 0 for the lower half of
    the TF: whole slices classify empty on every axis."""
    rng = np.random.default_rng(1)
    vol = np.zeros((20, 24, 28), dtype=np.float32)
    vol[7:13, 8:16, 9:19] = rng.random((6, 8, 10), dtype=np.float32) * 0.5 + 0.5
    tf = tf_j.default_color_map(64)
    tf[:32, 3] = 0.0
    return vol, tf


def saturated_scene():
    """A near-opaque volume: the early exit fires on every ray that hits."""
    vol = np.full((16, 16, 16), 0.95, np.float32)
    tf = tf_j.default_color_map(64)
    tf[:, 3] = 0.9
    return vol, tf


def plan_args(eye, params=None, swp=None):
    """The same view plan for both packages (their planners are the same
    numpy code)."""
    cam_j, cam_t = cameras(eye)
    params_j = ParamsJ(**(params or PARAMS))
    params_t = ParamsT(**(params or PARAMS))
    swp_cfg = swp or SWP
    plan_j = sw_j.make_plan(cam_j)
    plan_t = sw_t.make_plan(cam_t)
    assert plan_t.bounds == plan_j.bounds and plan_t.axis == plan_j.axis
    pa_j = swp_j.slope_grid_plan_args(plan_j, GMIN, GMAX, params_j, sw_j.ShearWarpParams(**swp_cfg))
    pa_t = swd.slope_grid_plan_args(plan_t, GMIN, GMAX, params_t, sw_t.ShearWarpParams(**swp_cfg))
    return pa_j, pa_t, plan_j, plan_t


def extents(vol, axis):
    perm = sw_t._PERM[axis]
    return vol.shape[perm[1]], vol.shape[perm[2]]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_classify_planes_matches_jax(axis):
    vol, tf = sparse_scene()
    chans_j = swp_j.classify_planes(jnp.asarray(vol), jnp.asarray(tf), axis, (0.0, 1.0))
    nc, nb = extents(vol, axis)
    want = interop.classified_from_jax(np.asarray(chans_j), nc, nb)
    got = swd.classify_planes(torch.from_numpy(vol), torch.from_numpy(tf), axis, (0.0, 1.0))
    assert got.shape == want.shape == (vol.shape[sw_t._PERM[axis][0]], nc, nb, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    content = swd.slice_content(got).numpy()
    np.testing.assert_array_equal(content, np.asarray(swp_j.slice_content(chans_j)))
    assert content.min() == 0 and content.max() == 1
    # Chunking over slices changes nothing.
    one = swd.classify_planes(
        torch.from_numpy(vol), torch.from_numpy(tf), axis, (0.0, 1.0), chunk=1
    )
    assert torch.equal(one, got)


def classified_pair(vol, tf, pa_j, pa_t):
    """(JAX stack, JAX content, port stack, port content, nc, nb)."""
    chans_j = swp_j.classify_planes(jnp.asarray(vol), jnp.asarray(tf), pa_j["axis"], (0.0, 1.0))
    chans_t = swd.classify_planes(
        torch.from_numpy(vol), torch.from_numpy(tf), pa_t.axis, (0.0, 1.0)
    )
    nc, nb = extents(vol, pa_t.axis)
    return chans_j, swp_j.slice_content(chans_j), chans_t, swd.slice_content(chans_t), nc, nb


@pytest.mark.parametrize("eye", sorted(EYES))
@pytest.mark.parametrize("scene", ["random", "sparse"])
def test_classified_slope_grid_matches_jax(scene, eye):
    """The plain sweep (K5's specification) from the port's stack vs the
    JAX kernel from its own, with empty-space skipping; in the port,
    skipping on and off are bit-equal."""
    vol, tf = random_scene() if scene == "random" else sparse_scene()
    pa_j, pa_t, _, _ = plan_args(EYES[eye])
    chans_j, content_j, chans_t, content_t, nc, nb = classified_pair(vol, tf, pa_j, pa_t)
    want = np.asarray(swp_j.render_classified_slope_grid(
        chans_j, nc, nb, pa_j, True, content=content_j
    ))
    got = swd.render_classified_slope_grid(chans_t, nc, nb, pa_t, content=content_t)
    assert got.shape == (24, 40, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert float(got[..., 3].max()) > 0.1
    full = swd.render_classified_slope_grid(chans_t, nc, nb, pa_t)
    assert torch.equal(got, full)
    if scene == "sparse":
        assert int(content_t.min()) == 0


def test_saturated_volume_matches_jax():
    """The early exit fires; the plain sweep still matches the JAX kernel."""
    vol, tf = saturated_scene()
    pa_j, pa_t, _, _ = plan_args([0.1, 0.05, 1.3])
    chans_j, content_j, chans_t, content_t, nc, nb = classified_pair(vol, tf, pa_j, pa_t)
    want = np.asarray(swp_j.render_classified_slope_grid(
        chans_j, nc, nb, pa_j, True, content=content_j
    ))
    samples = torch.zeros(pa_t.swp.inter_size, dtype=torch.int64)
    _fv, tables = swd.sweep_operands(chans_t, pa_t, content=content_t)
    got = swd.pre_sweep_reference(chans_t, tables, samples=samples, **pa_t.sweep_kwargs())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert float(got[..., 3].max()) > 0.999
    # Saturated rays stop compositing well before the last plane.
    assert 0 < int(samples[got[..., 3] > 0.999].max()) < pa_t.swp.n_planes // 2


def test_touched_texels_are_all_the_sweep_reads():
    """``touched`` marks every texel the sweep reads: overwriting the
    others leaves the result bit-equal (the saturated scene, where the
    early exit stops every ray within a few slices); it marks only the
    slices of the planes sampled."""
    vol, tf = saturated_scene()
    _, pa_t, _, _ = plan_args([0.1, 0.05, 1.3])
    chans = swd.classify_planes(torch.from_numpy(vol), torch.from_numpy(tf), pa_t.axis, (0.0, 1.0))
    _fv, tables = swd.sweep_operands(chans, pa_t, content=swd.slice_content(chans))
    kw = pa_t.sweep_kwargs()
    touched = torch.zeros(chans.shape[:3], dtype=torch.bool)
    planes = torch.zeros(pa_t.swp.n_planes, dtype=torch.bool)
    want = swd.pre_sweep_reference(chans, tables, planes=planes, touched=touched, **kw)
    noise = torch.from_numpy(np.random.default_rng(5).random(chans.shape, dtype=np.float32))
    got = swd.pre_sweep_reference(torch.where(touched[..., None], chans, noise), tables, **kw)
    assert torch.equal(got, want)
    slices = torch.unique(torch.cat([tables.a0[planes], tables.a1[planes]]))
    assert slices.numel() < chans.shape[0] and int(touched[slices.long()].sum()) > 0
    unread = ~torch.isin(torch.arange(chans.shape[0]), slices)
    assert not bool(touched[unread].any())


@pytest.mark.parametrize("classification", ["pre", "post"])
def test_render_slope_grid_matches_jax(classification):
    vol, tf = random_scene()
    swp = dict(SWP, classification=classification)
    _, _, plan_j, plan_t = plan_args([0.3, 0.5, 1.2])
    want, ug_j, vg_j = sw_j.render_slope_grid(
        jnp.asarray(vol), jnp.asarray(tf), plan_j.eye, plan_j.axis, plan_j.sign,
        plan_j.bounds, GMIN, GMAX, ParamsJ(**PARAMS), sw_j.ShearWarpParams(**swp),
    )
    got, ug, vg = sw_t.render_slope_grid(
        torch.from_numpy(vol), torch.from_numpy(tf), plan_t.eye, plan_t.axis,
        plan_t.sign, plan_t.bounds, GMIN, GMAX, ParamsT(**PARAMS),
        sw_t.ShearWarpParams(**swp),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_allclose(ug.numpy(), np.asarray(ug_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vg.numpy(), np.asarray(vg_j), rtol=0, atol=1e-6)
    assert float(got[..., 3].max()) > 0.1


def test_render_and_warp_match_jax():
    """The plain full frame, and the warp alone on the same slope image."""
    vol, tf = random_scene()
    cam_j, cam_t = cameras([0.3, 0.5, 1.2])
    want = sw_j.render(jnp.asarray(vol), jnp.asarray(tf), cam_j, ParamsJ(**PARAMS),
                       GMIN, GMAX, sw_j.ShearWarpParams(**SWP))
    got = sw_t.render(torch.from_numpy(vol), torch.from_numpy(tf), cam_t, ParamsT(**PARAMS),
                      GMIN, GMAX, sw_t.ShearWarpParams(**SWP))
    assert got.shape == (32, 32, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)

    plan_j, plan_t = sw_j.make_plan(cam_j), sw_t.make_plan(cam_t)
    inter = np.random.default_rng(2).random((24, 40, 4), dtype=np.float32)
    ug = np.linspace(plan_j.bounds[0], plan_j.bounds[1], 40, dtype=np.float32)
    vg = np.linspace(plan_j.bounds[2], plan_j.bounds[3], 24, dtype=np.float32)
    want = sw_j.warp_to_screen(jnp.asarray(inter), jnp.asarray(ug), jnp.asarray(vg),
                               jnp.asarray(plan_j.u), jnp.asarray(plan_j.v),
                               jnp.asarray(plan_j.valid))
    got = sw_t.warp_to_screen(torch.from_numpy(inter), torch.from_numpy(ug),
                              torch.from_numpy(vg), *sw_t.plan_pixels(plan_t, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_pixel_slopes_match_jax():
    cam_j, cam_t = cameras([1.4, 0.1, 0.2])
    axis, sign = sw_t.choose_major_axis(cam_t)
    assert (axis, sign) == sw_j.choose_major_axis(cam_j) == (0, -1.0)
    for got, want in zip(sw_t.pixel_slopes(cam_t, axis, device="cpu"),
                         sw_j.pixel_slopes(cam_j, axis)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_render_frame_and_render_match_jax():
    """The one-upload frame (sweep + device warp) and the full render
    through the fused sweep."""
    vol, tf = random_scene()
    eye = [0.3, 0.5, 1.2]
    cam_j, cam_t = cameras(eye)
    pa_j, pa_t, _, _ = plan_args(eye)
    chans_j, content_j, chans_t, content_t, nc, nb = classified_pair(vol, tf, pa_j, pa_t)
    want = np.asarray(swp_j.render_frame(chans_j, nc, nb, cam_j, pa_j, interpret=True,
                                         content=content_j))
    got = swd.render_frame(chans_t, nc, nb, cam_t, pa_t, content=content_t)
    assert got.shape == (32, 32, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)

    want = swp_j.render(jnp.asarray(vol), jnp.asarray(tf), cam_j, ParamsJ(**PARAMS),
                        GMIN, GMAX, sw_j.ShearWarpParams(**SWP), interpret=True)
    got = swd.render(torch.from_numpy(vol), torch.from_numpy(tf), cam_t, ParamsT(**PARAMS),
                     GMIN, GMAX, sw_t.ShearWarpParams(**SWP))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_fused_gradients_match_jax():
    """The autograd Function's recompute backward vs ``jax.grad`` of the
    JAX custom VJP, for the volume and the TF, on a mean loss (as
    tests/test_shearwarp.py's gradient test): 1e-6 absolute, and 2e-5 of
    the largest gradient (f32 sums over 24 planes and 2-tap lerps, taken
    in another order)."""
    vol, tf = random_scene()
    pa_j, pa_t, _, _ = plan_args([0.3, 0.5, 1.2])
    g = np.random.default_rng(3).standard_normal((24, 40, 4)).astype(np.float32)

    def loss_j(v, t):
        return (swp_j.render_slope_grid_pallas(v, t, pa_j, True) * g).mean()

    grads_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))
    vol_t = torch.from_numpy(vol).requires_grad_()
    tf_t = torch.from_numpy(tf).requires_grad_()
    (swd.render_slope_grid_fused(vol_t, tf_t, pa_t) * torch.from_numpy(g)).mean().backward()
    for got, want in zip((vol_t.grad.numpy(), tf_t.grad.numpy()), map(np.asarray, grads_j)):
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert float(np.abs(got - want).max()) <= 2e-5 * scale
    # Only the TF: the volume gets no gradient.
    tf_only = torch.from_numpy(tf).requires_grad_()
    swd.render_slope_grid_fused(torch.from_numpy(vol), tf_only, pa_t).sum().backward()
    assert tf_only.grad is not None


def test_pre_sweep_operands_and_counts():
    """Bad operands raise; on the CPU the wrapper runs the plain version
    (no launch); ``samples`` and ``planes`` count the work and change
    nothing."""
    vol, tf = sparse_scene()
    _, pa_t, _, _ = plan_args([0.2, 0.1, 1.4])
    chans = swd.classify_planes(torch.from_numpy(vol), torch.from_numpy(tf), pa_t.axis, (0.0, 1.0))
    content = swd.slice_content(chans)
    _fv, tables = swd.sweep_operands(chans, pa_t, content=content)
    kw = pa_t.sweep_kwargs()
    with pytest.raises(TypeError):
        swd.pre_sweep(chans.double(), tables, **kw)
    with pytest.raises(ValueError):
        swd.pre_sweep(chans[..., :3].contiguous(), tables, **kw)
    with pytest.raises(ValueError):
        swd.pre_sweep(chans.transpose(1, 2), tables, **kw)
    with pytest.raises(ValueError):
        swd.render_classified_slope_grid(chans, chans.shape[1] + 1, chans.shape[2], pa_t)
    launches = swd.pre_sweep.launches
    out = swd.pre_sweep(chans, tables, **kw)
    assert swd.pre_sweep.launches == launches
    spelled_out = swd.render_from_classified(
        chans, nc_real=chans.shape[1], nb_real=chans.shape[2], eye=pa_t.eye,
        axis=pa_t.axis, sign=pa_t.sign, slope_bounds=pa_t.slope_bounds,
        world_min=GMIN, world_max=GMAX, params=pa_t.params, swp=pa_t.swp, content=content,
    )
    assert torch.equal(spelled_out, out)
    samples = torch.zeros(pa_t.swp.inter_size, dtype=torch.int64)
    planes = torch.zeros(pa_t.swp.n_planes, dtype=torch.bool)
    again = swd.pre_sweep_reference(chans, tables, samples=samples, planes=planes, **kw)
    assert torch.equal(out, again)
    active = int(tables.act.sum())
    assert 0 < active < pa_t.swp.n_planes
    assert int(samples.max()) <= active and int(planes.sum()) <= active
    assert float(out[..., 3][samples == 0].abs().max()) == 0.0
    assert int(samples.min()) == 0 < int(samples.max())


def test_classified_from_jax_and_params():
    vol, tf = random_scene()
    chans_j = np.array(swp_j.classify_planes(jnp.asarray(vol), jnp.asarray(tf), 2, (0.0, 1.0)))
    assert interop.classified_from_jax(chans_j, 24, 28).shape == (20, 24, 28, 4)
    chans_j[0, 3 * 128 + 30, 0] = 0.5  # the alpha channel's c padding
    with pytest.raises(ValueError, match="padding"):
        interop.classified_from_jax(chans_j, 24, 28)
    assert sw_t.ShearWarpParams(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        sw_t.ShearWarpParams(compute_dtype="float16")
    with pytest.raises(ValueError):
        sw_t.ShearWarpParams(classification="mid")
    with pytest.raises(TypeError, match="Mesh"):
        swd.render_slope_grid_sharded(None, None, 24, 28, None)
