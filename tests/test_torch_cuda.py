"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips where torch sees no GPU.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.data.datasource import DataSource, load_plugins
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.render.engine import RenderEngine
from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.testing import (
    DENSE_EYES,
    DENSE_GRAD_TOL,
    EXACT_GRAD_TOL_MAX,
    EXACT_TOL_MAX,
    EXACT_TOL_MEAN,
    FIELDS,
    GRAD_TOL_MAX,
    GRAD_TOL_MAX_EARLY_EXIT,
    GRAD_TOL_MEAN_EARLY_EXIT,
    KERNEL_TOL_MAX,
    KERNEL_TOL_MEAN,
    dense_case,
    dense_grad_case,
    exact_case,
    exact_grad_case,
    store_grad_case,
    sweep_case,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_grad_close(got, want, tol_max, tol_mean=None, expect_zero=False):
    """|got − want| normalised by max |want| within ``tol_max`` (and its
    mean within ``tol_mean``).  With ``expect_zero`` (K4's density
    gradient on the "top" field: every sample past the density gate) both
    must be exactly zero; otherwise the plain gradient must not be."""
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    if expect_zero:
        assert scale == 0.0 and float(got.abs().max()) == 0.0
        return
    assert scale > 0.0
    err = (got - want).abs() / scale
    assert float(err.max()) <= tol_max
    if tol_mean is not None:
        assert float(err.mean()) <= tol_mean


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape", [(96, 80, 128, 64, 48, 56), (512, 512, 512, 512, 512, 512)]
)
def test_post_sweep_kernel_matches_plain(cuda, shape):
    """Seeded store with SENTINEL holes, two clip planes, inactive planes
    and a saturating TF.  Tolerance: max 2e-3 (one flip of the
    early-exit test moves a pixel by at most 1 − 0.999), mean 1e-5 (powf
    rounding)."""
    store, tf, tables, clip, kw = sweep_case(shape, seed=0, device=cuda)
    launches = swb.post_sweep.launches
    got, t_got = swb.post_sweep(store, tf, tables, clip, **kw)
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, **kw)
    torch.cuda.synchronize()
    assert swb.post_sweep.launches == launches + 1
    for a, b in ((got, want), (t_got, t_want)):
        err = (a - b).abs()
        assert float(err.max()) <= KERNEL_TOL_MAX
        assert float(err.mean()) <= KERNEL_TOL_MEAN
    assert float((got[..., 3] > 0.999).float().mean()) > 0  # early exit fired


@pytest.mark.cuda
def test_engine_on_card_matches_cpu(cuda):
    """RenderEngine.render_bricked on the card (kernel) vs on the CPU
    (plain sweep): same frame within the kernel tolerance."""
    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(48, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    frames = [
        RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=d)
        .render_bricked(camera, frustum, screen_space_error=1.0, n_planes=64)[0]
        .cpu()
        for d in (cuda, "cpu")
    ]
    assert float((frames[0] - frames[1]).abs().max()) <= KERNEL_TOL_MAX
    assert float(frames[1][..., 3].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("diff_tf", [True, False])
@pytest.mark.parametrize("early_exit", [1.1, 0.999])
def test_store_grid_bwd_kernel_matches_plain(cuda, early_exit, diff_tf):
    """The backward kernel vs its plain version on seeded operands
    (SENTINEL holes, inactive planes), each gradient normalised by the
    plain one's max |·|.  Tolerance: max 1e-3 with the early exit off
    (float-atomic summation order, powf); with it on, max 1e-2 and mean 1e-5
    (a ray whose recomputed t crosses the threshold a plane apart
    changes its whole gradient)."""
    store, tf, tables, out, t_out, g, kw = store_grad_case(
        (96, 80, 128, 64, 48, 56), seed=0, device=cuda, early_exit=early_exit
    )
    launches = swg.store_grid_backward.launches
    ds, dtf = swg.store_grid_backward(
        store, tf, tables, out, t_out, g, diff_tf=diff_tf, **kw
    )
    ds_ref, dtf_ref = swg.store_grid_backward_reference(
        store, tf, tables, out, t_out, g, diff_tf=True, **kw
    )
    torch.cuda.synchronize()
    assert swg.store_grid_backward.launches == launches + 1
    pairs = [(ds, ds_ref)] + ([(dtf, dtf_ref)] if diff_tf else [])
    for got, want in pairs:
        err = (got - want).abs() / want.abs().max()
        if early_exit < 1.0:
            assert float(err.max()) <= GRAD_TOL_MAX_EARLY_EXIT
            assert float(err.mean()) <= GRAD_TOL_MEAN_EARLY_EXIT
        else:
            assert float(err.max()) <= GRAD_TOL_MAX
    if not diff_tf:
        assert float(dtf.abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("early_exit", [1.1, 0.999])
@pytest.mark.parametrize("field", FIELDS)
def test_store_grid_bwd_kernel_fields(cuda, field, early_exit):
    """K2 with the TF gradient on each seeded field (``FIELDS``: bins
    unrelated from sample to sample, one bin, bin 255, a bin that moves
    every few samples) vs its plain version, at the tolerances of
    ``test_store_grid_bwd_kernel_matches_plain``."""
    store, tf, tables, out, t_out, g, kw = store_grad_case(
        (96, 80, 128, 64, 48, 56), seed=0, device=cuda, early_exit=early_exit, field=field
    )
    got = swg.store_grid_backward(store, tf, tables, out, t_out, g, diff_tf=True, **kw)
    want = swg.store_grid_backward_reference(store, tf, tables, out, t_out, g, diff_tf=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if early_exit < 1.0:
            assert_grad_close(a, b, GRAD_TOL_MAX_EARLY_EXIT, GRAD_TOL_MEAN_EARLY_EXIT)
        else:
            assert_grad_close(a, b, GRAD_TOL_MAX)
    assert float(want[1].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("case", ["bricks", "single"])
def test_exact_march_kernel_matches_plain(cuda, case, filter_mode, dtype):
    """K3 vs ``march_exact_reference`` on ``exact_case`` operands: a
    scattered multi-brick atlas with clip planes, a saturating TF and a
    carry in, and the single 64³ brick of bench_exact.  Tolerance: max
    2e-3, mean 1e-5 (serial vs closed-form compositing; an early-exit
    flip moves a pixel by at most 1 − 0.999)."""
    c = exact_case(case, seed=0, device=cuda, filter_mode=filter_mode, dtype=dtype)
    n_rays, n_bricks = c.carry.shape[0], c.slots.shape[0]
    counts = [
        (torch.zeros(n_rays, dtype=torch.int32, device=cuda),
         torch.zeros(n_bricks, dtype=torch.int32, device=cuda))
        for _ in range(2)
    ]
    args = (c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params)
    launches = exact.march_exact.launches
    got = exact.march_exact(*args, max_steps=c.max_steps, width=c.width,
                            samples=counts[0][0], used=counts[0][1])
    want = exact.march_exact_reference(*args, max_steps=c.max_steps,
                                       samples=counts[1][0], used=counts[1][1])
    torch.cuda.synchronize()
    assert exact.march_exact.launches == launches + 1
    err = (got - want).abs()
    assert float(err.max()) <= EXACT_TOL_MAX
    assert float(err.mean()) <= EXACT_TOL_MEAN
    assert float((got[:, 3] > 0.999).float().mean()) > 0  # early exit fired
    torch.testing.assert_close(counts[0][1], counts[1][1], rtol=0, atol=0)
    flips = int((counts[0][0] != counts[1][0]).sum())
    assert flips <= n_rays // 200, flips  # only early-exit flips move a count


@pytest.mark.cuda
def test_engine_render_on_card_matches_cpu(cuda):
    """RenderEngine.render on the card (K3) vs on the CPU (plain marcher),
    two jittered samples per pixel: same frame within the kernel
    tolerance."""
    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(48, 40, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    params = RenderParams(n_samples_per_ray=128, samples_per_pixel=2,
                          filter_mode="trilinear")
    launches = exact.march_exact.launches
    frames = [
        RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=d)
        .render(camera, frustum, params=params, screen_space_error=1.0)[0].cpu()
        for d in (cuda, "cpu")
    ]
    assert exact.march_exact.launches == launches + 2
    assert float((frames[0] - frames[1]).abs().max()) <= EXACT_TOL_MAX
    assert float(frames[1][..., 3].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("case", ["bench", "wide"])
def test_exact_march_bwd_kernel_matches_plain(cuda, case, filter_mode):
    """K4 vs ``march_exact_backward_reference`` on ``exact_grad_case``
    operands (the bench_exact shape; a brick whose extents across the
    march exceed 128, with clip planes and a jittered sample), each
    gradient normalised by the plain one's max |·|.  Tolerance: max 1e-3
    (serial vs closed-form inversion, float-atomic order)."""
    c = exact_grad_case(case, seed=0, device=cuda, filter_mode=filter_mode)
    args = (c.volume, c.tf, c.view, c.out, c.g)
    launches = exact.march_exact_backward.launches
    got = exact.march_exact_backward(*args)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    assert exact.march_exact_backward.launches == launches + 1
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max() / b.abs().max()) <= EXACT_GRAD_TOL_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("field", [f for f in FIELDS if f != "random"])
def test_exact_march_bwd_kernel_fields(cuda, field, filter_mode):
    """K4 vs its plain version at the bench_exact shape on the flat, top
    and smooth fields (``FIELDS``), at the tolerance of
    ``test_exact_march_bwd_kernel_matches_plain``."""
    c = exact_grad_case("bench", seed=0, device=cuda, filter_mode=filter_mode, field=field)
    args = (c.volume, c.tf, c.view, c.out, c.g)
    got = exact.march_exact_backward(*args)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        assert_grad_close(a, b, EXACT_GRAD_TOL_MAX, expect_zero=field == "top" and i == 0)
    assert float(want[1].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS)
def test_exact_march_bwd_kernel_without_tf_gradient(cuda, field):
    """K4 with ``diff_tf=False``: d_volume within the kernel tolerance of
    the ``diff_tf=True`` launch (float atomics add in another order), and
    d_tf exactly zero."""
    c = exact_grad_case("bench", seed=0, device=cuda, field=field)
    args = (c.volume, c.tf, c.view, c.out, c.g)
    launches = exact.march_exact_backward.launches
    d_vol, d_tf = exact.march_exact_backward(*args)
    d_vol_off, d_tf_off = exact.march_exact_backward(*args, diff_tf=False)
    torch.cuda.synchronize()
    assert exact.march_exact_backward.launches == launches + 2
    assert_grad_close(d_vol_off, d_vol, EXACT_GRAD_TOL_MAX, expect_zero=field == "top")
    assert float(d_tf_off.abs().max()) == 0.0 and float(d_tf.abs().max()) > 0


@pytest.mark.cuda
def test_render_exact_diff_on_card_matches_cpu(cuda):
    """Autograd through K3 and K4 on the card vs the plain versions on the
    CPU, on the "wide" case (a (24, 144, 136) volume, 96×80 rays, clip
    planes, a jittered sample)."""
    c = exact_grad_case("wide", seed=1, device="cpu")
    grads = []
    for dev in (cuda, "cpu"):
        view = dataclasses.replace(
            c.view, ray_pack=c.view.ray_pack.to(dev), brick_boxes=c.view.brick_boxes.to(dev)
        )
        vol = c.volume.to(dev).requires_grad_()
        tf = c.tf.to(dev).requires_grad_()
        (exact.render_exact_diff(vol, tf, view) * c.g.to(dev)).sum().backward()
        grads.append((vol.grad.cpu(), tf.grad.cpu()))
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / b.abs().max()) <= EXACT_GRAD_TOL_MAX


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,eye", [("scene", eye) for eye in sorted(DENSE_EYES)] + [("slice", "z-")]
)
def test_pre_sweep_kernel_matches_plain(cuda, case, eye):
    """K5 vs ``pre_sweep_reference`` on ``dense_case`` operands: the JAX
    package's dense test scene from every axis and sign (empty slices, a
    saturating TF) and a 512³ stack under 512² rays × 512 planes.
    Tolerance: K1's, max 2e-3 (an early-exit flip), mean 1e-5 (powf)."""
    c = dense_case(case, seed=0, device=cuda, eye=eye)
    kw = c.plan_args.sweep_kwargs()
    launches = swd.pre_sweep.launches
    got = swd.pre_sweep(c.chans, c.tables, **kw)
    want = swd.pre_sweep_reference(c.chans, c.tables, **kw)
    torch.cuda.synchronize()
    assert swd.pre_sweep.launches == launches + 1
    err = (got - want).abs()
    assert float(err.max()) <= KERNEL_TOL_MAX
    assert float(err.mean()) <= KERNEL_TOL_MEAN
    assert float((got[..., 3] > kw["early_exit"]).float().mean()) > 0  # early exit fired
    assert int(c.tables.act.sum()) < c.tables.act.numel()  # empty planes skipped


@pytest.mark.cuda
def test_engine_shearwarp_on_card_matches_cpu(cuda):
    """RenderEngine.render_shearwarp on the card (K5 over the classified
    stack) vs on the CPU (the plain pipeline): same frame within the
    kernel tolerance."""
    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, _frustum = build_camera(48, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    launches = swd.pre_sweep.launches
    frames = [
        RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=d)
        .render_shearwarp(camera, n_planes=64).cpu()
        for d in (cuda, "cpu")
    ]
    assert swd.pre_sweep.launches == launches + 1
    assert float((frames[0] - frames[1]).abs().max()) <= KERNEL_TOL_MAX
    assert float(frames[1][..., 3].max()) > 0


@pytest.mark.cuda
def test_render_slope_grid_fused_on_card_matches_cpu(cuda):
    """The dense autograd Function on the card (classify + K5, recompute
    backward) vs on the CPU, early exit off: forward within K1's max,
    volume and TF gradients within 1e-4 of the CPU's largest."""
    results = []
    for dev in (cuda, "cpu"):
        vol_t, tf_t, g, pa = dense_grad_case(dev)
        out = swd.render_slope_grid_fused(vol_t, tf_t, pa)
        (out * g).sum().backward()
        results.append((out.detach().cpu(), vol_t.grad.cpu(), tf_t.grad.cpu()))
    assert float((results[0][0] - results[1][0]).abs().max()) <= KERNEL_TOL_MAX
    for a, b in zip(results[0][1:], results[1][1:]):
        assert float((a - b).abs().max() / b.abs().max()) <= DENSE_GRAD_TOL
