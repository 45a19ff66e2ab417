"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips where torch sees no GPU.

This file imports neither jax nor the JAX package, so it also runs where
jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import copy
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.benchmarks import MODULES as PROBE_MODULES
from libre_tpu_torch.benchmarks._probe import plain_of
from libre_tpu_torch.data.datasource import DataSource, load_plugins
from libre_tpu_torch.ops import exact, gather, raycast
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.ops import transfer_function as tfm
from libre_tpu_torch.render.engine import RenderEngine
from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.testing import (
    DENSE_EYES,
    DENSE_GRAD_TOL,
    DENSE_SWEEP_SHAPES,
    EXACT_BRICK_VIEWS,
    EXACT_GRAD_TOL_MAX,
    EXACT_TOL_MAX,
    EXACT_TOL_MEAN,
    FIELDS,
    GRAD_TOL_MAX,
    GRAD_TOL_MAX_EARLY_EXIT,
    GRAD_TOL_MEAN_EARLY_EXIT,
    KERNEL_TOL_MAX,
    KERNEL_TOL_MEAN,
    SWEEP_VIEWS,
    TF_LOOKUP_SIZES,
    assert_tf_lookup_grads,
    dense_case,
    dense_grad_case,
    dense_plain,
    exact_case,
    exact_grad_case,
    exact_set_grad_case,
    lookup_backward_reference,
    store_grad_case,
    sweep_case,
    tf_lookup_bounds,
    tf_lookup_densities,
    tf_of_size,
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
@pytest.mark.parametrize(
    "shape", [(96, 80, 128, 64, 48, 56), (512, 512, 512, 512, 512, 512)]
)
@pytest.mark.parametrize("view", sorted(SWEEP_VIEWS))
def test_post_sweep_kernel_bit_equal(cuda, view, shape):
    """K1 walks per-tile plane lists; on every seeded view (on axis, the
    eye inside the volume, oblique; K != Na and K = Na) its colour,
    alpha and transmittance are bit-equal to ``post_sweep_reference``,
    and the plain lists hold every plane a tile fetches at."""
    store, tf, tables, clip, kw = sweep_case(shape, seed=0, device=cuda, view=view)
    got, t_got = swb.post_sweep(store, tf, tables, clip, **kw)
    v_size, u_size = tables.corr.shape
    rows, cols = swb.SWEEP_TILE
    fetches = torch.zeros((-(-v_size // rows), -(-u_size // cols), tables.a0.shape[0]),
                          dtype=torch.bool, device=cuda)
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, fetches=fetches, **kw)
    lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(t_got, t_want)
    assert bool((fetches <= lists).all()) and int(fetches.sum()) > 0


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
@pytest.mark.parametrize("diff_tf", [True, False])
def test_store_grid_bwd_kernel_adds_into_given_buffers(cuda, diff_tf):
    """Handed a non-zero ``d_store`` and ``dtf``, the backward kernel
    returns those tensors holding what they held plus its fresh
    gradients (normalised by the fresh ones' max |·|, within the
    atomics' 1e-3) and counts one accumulated launch; with ``diff_tf``
    off ``dtf`` is left as it was."""
    store, tf, tables, out, t_out, g, kw = store_grad_case(
        (96, 80, 128, 64, 48, 56), seed=0, device=cuda, early_exit=1.1
    )
    ds, dtf = swg.store_grid_backward(store, tf, tables, out, t_out, g, diff_tf=True, **kw)
    gen = torch.Generator(device=cuda).manual_seed(1)
    base_s = torch.randn(ds.shape, device=cuda, generator=gen) * ds.abs().max()
    base_t = torch.randn(dtf.shape, device=cuda, generator=gen) * dtf.abs().max()
    d_store, d_tf = base_s.clone(), base_t.clone()
    accumulated = swg.store_grid_backward.accumulated
    got_s, got_t = swg.store_grid_backward(
        store, tf, tables, out, t_out, g, diff_tf=diff_tf, d_store=d_store, dtf=d_tf, **kw
    )
    torch.cuda.synchronize()
    assert got_s is d_store and got_t is d_tf
    assert swg.store_grid_backward.accumulated == accumulated + 1
    pairs = [(got_s, base_s, ds)] + ([(got_t, base_t, dtf)] if diff_tf else [])
    for got, base, fresh in pairs:
        assert float(fresh.abs().max()) > 0.0
        assert float((got - base - fresh).abs().max() / fresh.abs().max()) <= GRAD_TOL_MAX
    if not diff_tf:
        assert torch.equal(got_t, base_t)


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
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("case", sorted(EXACT_BRICK_VIEWS))
def test_exact_march_kernel_brick_lists(cuda, case, filter_mode):
    """K3 walks per-tile brick lists; from every multi-brick view (off
    axis with a saturating TF, the eye inside the volume and inside a
    brick, rays along brick faces, a jittered sample; clip planes, a carry
    in) it holds the tolerances of ``test_exact_march_kernel_matches_plain``,
    flags the plain march's bricks, counts its samples on every ray the
    early exit did not end (and on all but one ray in 200), and the plain
    lists hold every brick a tile samples."""
    c = exact_case(case, seed=0, device=cuda, filter_mode=filter_mode, dtype=torch.uint8)
    n_rays, n_bricks = c.carry.shape[0], c.slots.shape[0]
    counts = [
        (torch.zeros(n_rays, dtype=torch.int32, device=cuda),
         torch.zeros(n_bricks, dtype=torch.int32, device=cuda))
        for _ in range(2)
    ]
    lists = raycast.tile_bricks_reference(c.rays, c.boxes, c.eye, c.width)
    tile_used = torch.zeros_like(lists)
    args = (c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params)
    got = exact.march_exact(*args, max_steps=c.max_steps, width=c.width,
                            samples=counts[0][0], used=counts[0][1])
    want = exact.march_exact_reference(*args, max_steps=c.max_steps, samples=counts[1][0],
                                       used=counts[1][1], width=c.width, tile_used=tile_used)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert float(err.max()) <= EXACT_TOL_MAX
    assert float(err.mean()) <= EXACT_TOL_MEAN
    assert torch.equal(counts[0][1], counts[1][1])
    ended = (got[:, 3] > c.params.early_exit) | (want[:, 3] > c.params.early_exit)
    moved = counts[0][0] != counts[1][0]
    assert not bool((moved & ~ended).any())
    assert int(moved.sum()) <= n_rays // 200, int(moved.sum())
    assert bool((tile_used <= lists).all()) and int(tile_used.sum()) > 0


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
    saturating TF) and a 512³ stack under 512² rays × 512 planes (K =
    Na).  Bit-equal, within K1's tolerance a fortiori, and the plain plane
    lists hold every plane a tile composites at."""
    c = dense_case(case, seed=0, device=cuda, eye=eye)
    kw = c.kw
    launches = swd.pre_sweep.launches
    got = swd.pre_sweep(c.chans, c.tables, **kw)
    want, fetches, lists = dense_plain(c)
    torch.cuda.synchronize()
    assert swd.pre_sweep.launches == launches + 1
    err = (got - want).abs()
    assert float(err.max()) <= KERNEL_TOL_MAX
    assert float(err.mean()) <= KERNEL_TOL_MEAN
    assert torch.equal(got, want)
    assert bool((fetches <= lists).all()) and int(fetches.sum()) > 0
    assert float((got[..., 3] > kw["early_exit"]).float().mean()) > 0  # early exit fired
    assert int(c.tables.act.sum()) < c.tables.act.numel()  # empty planes skipped


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DENSE_SWEEP_SHAPES)
@pytest.mark.parametrize("view", sorted(SWEEP_VIEWS))
def test_pre_sweep_kernel_bit_equal(cuda, view, shape):
    """K5 walks per-tile plane lists; on a classified stack with empty
    slices under every seeded view (ragged tiles, both sweep directions, dl changing sign;
    K ≠ Na and K = Na) it is bit-equal to ``pre_sweep_reference``, and the
    plain lists hold every plane a tile composites at."""
    c = dense_case("sweep", seed=0, device=cuda, view=view, shape=shape)
    got = swd.pre_sweep(c.chans, c.tables, **c.kw)
    want, fetches, lists = dense_plain(c)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((fetches <= lists).all()) and int(fetches.sum()) > 0


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


def _ooc_frame(engine, camera, frustum, monkeypatch, **kw):
    """One ``render_bricked`` frame with its K1 launches, its slab passes'
    brick lists, the atlas copies' slots and the plain sweeps counted."""
    passes, copies, plain = [], [], []
    real_nodes, real_copy = engine._slab_nodes, engine.atlas._copy
    real_plain = swb.post_sweep_reference
    monkeypatch.setattr(engine, "_slab_nodes", lambda *a: passes.append(real_nodes(*a))
                        or passes[-1])
    monkeypatch.setattr(engine.atlas, "_copy", lambda slots, host: (
        copies.append(list(slots)), real_copy(slots, host)))
    monkeypatch.setattr(swb, "post_sweep_reference", lambda *a, **k: (
        plain.append(1), real_plain(*a, **k))[1])
    before = swb.post_sweep.launches
    img, stats = engine.render_bricked(camera, frustum, **kw)
    torch.cuda.synchronize()
    monkeypatch.undo()
    return img, stats, swb.post_sweep.launches - before, passes, copies, plain


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slabs", "clipped", "chunks"])
def test_out_of_core_frame_bit_equal_on_card(cuda, case, monkeypatch):
    """The out-of-core frame on the card is the in-core frame bit for bit:
    K1 launches once per pass with bricks and not for an empty one, no
    plain sweep runs; with a 20-slot atlas ("chunks") slabs are paged in
    chunks and a slot is evicted and refilled between two passes of the
    frame."""
    from libre_tpu_torch.core.clip_planes import ClipPlanes

    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(64, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    kw = dict(screen_space_error=1.0, n_planes=64, min_lod=2)
    if case == "clipped":
        kw["clip_planes"] = ClipPlanes([[0.0, 0.0, 1.0, -0.05]])  # keep z ≥ 0.05
    whole, s_whole = RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=cuda) \
        .render_bricked(camera, frustum, **kw)
    slot_bytes = 24 ** 3
    budget = 1 if case != "chunks" else 20 * slot_bytes * 2 / 2**20
    engine = RenderEngine(DataSource(uri), max_gpu_cache_mb=budget, device=cuda)
    img, stats, launches, passes, copies, plain = _ooc_frame(
        engine, camera, frustum, monkeypatch, **kw)
    assert s_whole.n_passes == 1 and stats.n_passes == len(passes) > 1
    assert launches == sum(1 for p in passes if p) and not plain
    assert torch.equal(img, whole) and float(img[..., 3].max()) > 0.1
    if case == "clipped":
        assert launches < stats.n_passes
    if case == "chunks":
        assert engine.atlas.n_slots == 20 and engine.texture_cache.statistics.evictions > 0
        refilled = {s for c in copies for s in c}
        assert sum(len(c) for c in copies) > len(refilled)


@pytest.mark.cuda
def test_async_frames_converge_on_card(cuda):
    """Asynchronous ``render_bricked`` and ``render`` on cold engines: the
    uploads run on the pool's threads onto the atlas's stream while frames
    are enqueued, and the frame after they land is the synchronous frame
    bit for bit."""
    import threading

    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(48, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    params = RenderParams(n_samples_per_ray=128, filter_mode="trilinear")
    for method, kw in (("render_bricked", dict(n_planes=64, min_lod=2)),
                       ("render", dict(params=params))):
        sync = getattr(RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=cuda), method)(
            camera, frustum, screen_space_error=1.0, **kw)[0]
        engine = RenderEngine(DataSource(uri), max_gpu_cache_mb=64, device=cuda)
        assert engine.atlas.stream == torch.cuda.current_stream(cuda)
        threads = []
        real_copy = engine.atlas._copy
        engine.atlas._copy = lambda slots, host: (threads.append(threading.get_ident()),
                                                  real_copy(slots, host))
        frames = 0
        while True:
            out = getattr(engine, method)(camera, frustum, screen_space_error=1.0,
                                          synchronous=False, **kw)
            img, stats = out[0], out[1]
            frames += 1
            if stats.rendering_done:
                break
            for f in stats.pending_uploads:
                f.result(timeout=60)
            assert frames < 20
        torch.cuda.synchronize()
        assert frames > 1 and threading.get_ident() not in threads[:1]
        assert torch.equal(img, sync), method


def _converge(engine, camera, frustum, **kw):
    """``render_bricked(synchronous=False)`` until the frame is done."""
    for _ in range(20):
        img, stats = engine.render_bricked(camera, frustum, synchronous=False, **kw)
        if stats.rendering_done:
            return img, stats
        for f in stats.pending_uploads:
            f.result(timeout=60)
    raise AssertionError("async frame not done after 20 frames")


@pytest.mark.cuda
@pytest.mark.parametrize("made_under", ["default", "side"])
@pytest.mark.parametrize("frame", ["out_of_core", "async"])
def test_frame_under_side_stream_bit_equal(cuda, frame, made_under, monkeypatch):
    """A frame rendered while another stream than the atlas's is current
    is the frame rendered on the atlas's stream, bit for bit: the
    out-of-core frame of the 20-slot atlas that refills slots within a
    frame, and an asynchronous frame once converged.  Every kernel
    launches on the atlas's stream, and the caller's stream may read the
    image at once (the clone below runs on it).  ``made_under`` is the
    stream current when the engine (and so its atlas) was made."""
    load_plugins()
    uri = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(64, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    kw = dict(screen_space_error=1.0, n_planes=64, min_lod=2)
    budget = 20 * 24 ** 3 * 2 / 2**20 if frame == "out_of_core" else 64
    side = torch.cuda.Stream(cuda)

    def render(current):
        made = side if made_under == "side" else torch.cuda.default_stream(cuda)
        with torch.cuda.stream(made):
            engine = RenderEngine(DataSource(uri), max_gpu_cache_mb=budget, device=cuda)
        streams = []
        real_launch = swb._kernels.launch
        monkeypatch.setattr(swb._kernels, "launch", lambda *a: (
            streams.append(torch.cuda.current_stream(cuda)), real_launch(*a)))
        with torch.cuda.stream(current) if current is not None else contextlib.nullcontext():
            if frame == "out_of_core":
                img, stats = engine.render_bricked(camera, frustum, **kw)
                assert stats.n_passes > 1 and engine.atlas.n_slots == 20
                assert engine.texture_cache.statistics.evictions > 0
            else:
                img, stats = _converge(engine, camera, frustum, **kw)
            out = img.clone()
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert streams and all(s == engine.atlas.stream for s in streams)
        return out

    on_atlas = render(None if made_under == "default" else side)
    under_other = render(side if made_under == "default" else torch.cuda.default_stream(cuda))
    assert float(on_atlas[..., 3].max()) > 0.1
    assert torch.equal(under_other, on_atlas)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_brick_histogram_on_card_equals_cpu(cuda, dtype):
    """``compute_brick_histogram`` counting on the card = on the CPU."""
    from libre_tpu_torch.core.volume_info import DataType
    from libre_tpu_torch.ops.histogram_ops import compute_brick_histogram

    rng = np.random.default_rng(0)
    if dtype == "float32":
        data = (rng.integers(0, 257, (24, 20, 28)) / 256.0 * 3.0 + 0.25).astype(np.float32)
    else:
        data = rng.integers(0, np.iinfo(dtype).max + 1, (24, 20, 28)).astype(dtype)
    for overlap in ((0, 0, 0), (2, 1, 3)):
        for data_range in (None, DataType(dtype).default_range):
            got = compute_brick_histogram(data, overlap, DataType(dtype), data_range,
                                          device=cuda)
            want = compute_brick_histogram(data, overlap, DataType(dtype), data_range,
                                           device="cpu")
            assert np.array_equal(got.bins, want.bins)
            assert (got.min_value, got.max_value) == (want.min_value, want.max_value)


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", ["bricked", "exact"])
def test_render_service_on_card_matches_cpu(cuda, renderer):
    """One ``RenderService`` frame on the card (K1 or K3) within 2e-3 max
    and 1e-4 mean of the same service's frame on the CPU, with the same
    histogram."""
    from libre_tpu_torch.apps.serve import RenderService

    frames = []
    for dev in (cuda, "cpu"):
        svc = RenderService("mem://#64,64,64,16?pattern=gradient", width=48, height=40,
                            port=0, max_gpu_cache_mb=64, device=dev)
        svc.server.params.update(synchronous=True, sse=1.0, renderer=renderer)
        frames.append((svc.render_frame(), svc._histogram))
    (got, hist), (want, hist_cpu) = frames
    d = np.abs(got - want)
    assert float(d.max()) <= 2e-3 and float(d.mean()) <= 1e-4
    assert float(want[..., 3].max()) > 0.1 and hist == hist_cpu


PROBES = [p for m in PROBE_MODULES
          for p in importlib.import_module(f"libre_tpu_torch.benchmarks.{m}").PROBES]


def _gather_case(wrapper, table_shape, idx_range, idx_shape, **kw):
    """A build of a probe-like case: a seeded table, int32 indices in
    ``idx_range`` (and, for a ``lane`` of width w, lanes in [0, w))."""
    lane, offset = kw.pop("lane", False), kw.pop("offset", False)

    def build(device, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        table = torch.randn(table_shape, generator=g, device=device)
        lo, hi = idx_range
        idx = torch.randint(lo, hi, idx_shape, generator=g, device=device, dtype=torch.int32)
        args = (table, idx)
        if lane:
            args += (torch.randint(0, table_shape[-1], idx_shape, generator=g, device=device,
                                   dtype=torch.int32),)
        if offset:  # a view 4 bytes past an aligned start
            args = (table, torch.cat([idx.new_zeros(1), idx.reshape(-1)])[1:].reshape(idx_shape),
                    *args[2:])
        return functools.partial(wrapper, **kw), args, idx.numel()
    return build


def _nearest_case(table_shape, n, *, outside="clip", offset=False):
    """A build of a nearest TF lookup: a seeded (T,) or (T, C) table and
    ``n`` densities in [-0.5, 1.5) with the edge values first, scaled by
    T; with ``offset`` the densities (C = 1) or the table (C > 1) are a
    contiguous view 4 bytes past an aligned start."""

    def build(device, seed):
        g = torch.Generator(device=device).manual_seed(seed)
        tf = torch.rand(table_shape, generator=g, device=device)
        d = _edge_densities((n,), g, device)
        if offset and tf.dim() == 1:
            d = torch.cat([d.new_zeros(1), d])[1:]
        elif offset:
            tf = torch.cat([tf.new_zeros(1), tf.reshape(-1)])[1:].reshape(table_shape)
        fn = functools.partial(gather.tf_nearest, scale=float(table_shape[0]), outside=outside)
        return fn, (d, tf), n
    return build


# The redesigned paths at inputs the probes do not reach (ids name them):
# the staged loop sum with no mod, a mod below its chunk, a ragged loop and
# ragged lanes; the loop sum too large to stage, on either axis; the vector
# take with rows of 12 and of 6, lanes, an output count that is no multiple
# of 4, and unaligned indices (the scalar path); the nearest lookup's float4
# instances (C = 1 and 4, "clip" and "zero", a ragged density count, T = 1)
# and its scalar instance (C = 3, and operands that are not 16 B aligned);
# the single gather on both axes with ragged rows, with a mod, with
# unaligned indices, and one lane a row over a ragged count.
GATHER_CASES = [
    ("loop no mod", _gather_case(gather.take_along, (8, 1024), (0, 512), (8, 128),
                                 axis=1, loop=512)),
    ("loop mod 5", _gather_case(gather.take_along, (8, 128), (-40, 40), (8, 100),
                                axis=1, loop=37, mod=5)),
    ("loop ragged axis 0", _gather_case(gather.take_along, (24, 45), (-100, 100), (3, 45),
                                        axis=0, loop=83, mod=24)),
    ("loop ragged axis 1", _gather_case(gather.take_along, (5, 300), (0, 300), (5, 70),
                                        axis=1, loop=29, mod=300)),
    ("loop unstaged axis 1", _gather_case(gather.take_along, (6, 13000), (-20000, 20000),
                                          (6, 90), axis=1, loop=3, mod=13000)),
    ("loop unstaged axis 0", _gather_case(gather.take_along, (400, 37), (-1000, 1000), (11, 37),
                                          axis=0, loop=5, mod=400)),
    ("take row 12", _gather_case(gather.take, (300, 12), (0, 300), (37,), row=12)),
    ("take row 6", _gather_case(gather.take, (300, 6), (0, 300), (37,), row=6)),
    ("take lane", _gather_case(gather.take, (256, 128), (0, 256), (1027,), lane=True)),
    ("take ragged count", _gather_case(gather.take, (4099,), (0, 4099), (7, 147))),
    ("take unaligned", _gather_case(gather.take, (4099,), (0, 4099), (1021,), offset=True)),
    ("nearest C=1", _nearest_case((256,), 4096)),
    ("nearest C=1 zero", _nearest_case((256,), 4096, outside="zero")),
    ("nearest C=1 ragged", _nearest_case((256,), 4099)),
    ("nearest C=1 unaligned", _nearest_case((256,), 1021, offset=True)),
    ("nearest C=3", _nearest_case((64, 3), 1000)),
    ("nearest C=3 zero", _nearest_case((64, 3), 1000, outside="zero")),
    ("nearest C=4", _nearest_case((256, 4), 3001)),
    ("nearest C=4 zero", _nearest_case((256, 4), 3001, outside="zero")),
    ("nearest C=4 unaligned table", _nearest_case((256, 4), 3001, offset=True)),
    ("nearest T=1", _nearest_case((1,), 1023)),
    ("nearest T=1 C=4 zero", _nearest_case((1, 4), 1023, outside="zero")),
    ("single ragged axis 1", _gather_case(gather.take_along, (5, 300), (0, 300), (5, 70), axis=1)),
    ("single ragged axis 0", _gather_case(gather.take_along, (300, 45), (0, 300), (7, 45),
                                          axis=0)),
    ("single mod axis 1", _gather_case(gather.take_along, (9, 40), (-100, 100), (9, 33),
                                       axis=1, mod=37)),
    ("single mod axis 0", _gather_case(gather.take_along, (24, 45), (-100, 100), (3, 45),
                                       axis=0, mod=24)),
    ("single unaligned", _gather_case(gather.take_along, (512, 37), (0, 512), (40, 37),
                                      axis=0, offset=True)),
    ("single one lane ragged", _gather_case(gather.take_along, (1001, 3), (0, 3), (1001, 1),
                                            axis=1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("probe", PROBES + [c for _, c in GATHER_CASES],
                         ids=[p.id for p in PROBES] + [n for n, _ in GATHER_CASES])
def test_gather_probe_kernel_bit_equal(cuda, probe):
    """Each gather probe (P1-P17) at its full shape, and each case of
    ``GATHER_CASES``: one launch of its kernel, bit-equal to the plain
    version on the same seeded inputs."""
    build = probe.build if hasattr(probe, "build") else probe
    fn, args, _work = build(device=cuda, seed=0)
    launches = fn.func.launches
    got = fn(*args)
    want = plain_of(fn)(*args)
    torch.cuda.synchronize()
    assert fn.func.launches == launches + 1
    assert got.shape == want.shape and torch.equal(got, want)


def _edge_densities(shape, g, cuda):
    d = torch.rand(shape, generator=g, device=cuda) * 2.0 - 0.5
    special = torch.tensor([0.0, -0.0, 1.0, 255 / 256, 256 / 255, -1 / 255, 1.5], device=cuda)
    d.view(-1)[: special.numel()] = special
    return d


GATHER_EDGES = {
    # densities below 0 and at or above 1: clipped (P11, P13) or zero (P17)
    "nearest clip": lambda g, c: (gather.tf_nearest, (_edge_densities((8, 64, 256), g, c),
                                                      torch.rand(256, generator=g, device=c)),
                                  dict(scale=256.0, outside="clip")),
    "nearest zero": lambda g, c: (gather.tf_nearest, (_edge_densities((1024, 128), g, c),
                                                      torch.rand(256, 4, generator=g, device=c)),
                                  dict(scale=255.0, outside="zero")),
    "linear": lambda g, c: (gather.tf_linear, (_edge_densities((8, 64, 256), g, c),
                                               torch.rand(4, 256, generator=g, device=c)), {}),
    # a table and a grid of indices that are not multiples of the block
    "linear ragged": lambda g, c: (gather.tf_linear, (torch.rand(3, 7, 13, generator=g, device=c),
                                                      torch.rand(3, 17, generator=g, device=c)),
                                   {}),
    # negative indices wrap with a floored modulo; every loop wraps
    "loop wrap": lambda g, c: (gather.take_along, (
        torch.randn(9, 40, generator=g, device=c),
        torch.randint(-100, 100, (9, 33), generator=g, device=c, dtype=torch.int32)),
        dict(axis=1, loop=77, mod=37)),
    "sublane loop": lambda g, c: (gather.take_along, (
        torch.randn(12, 5, generator=g, device=c),
        torch.randint(0, 12, (7, 5), generator=g, device=c, dtype=torch.int32)),
        dict(axis=0, loop=30, mod=11)),
    # the last entry of the table, by flat index, by rows and by (row, lane)
    "last entries": lambda g, c: (gather.take, (
        torch.randn(300, 7, generator=g, device=c),
        torch.full((5, 3), 299, device=c, dtype=torch.int32)), dict(row=7)),
    "row lane": lambda g, c: (gather.take, (
        torch.randn(31, 7, generator=g, device=c),
        torch.tensor([30, 0, 30], device=c, dtype=torch.int32),
        torch.tensor([6, 6, 0], device=c, dtype=torch.int32)), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_EDGES))
def test_gather_kernels_edges(cuda, case):
    """Inputs the probes' own never reach, kernel bit-equal to plain."""
    g = torch.Generator(device=cuda).manual_seed(5)
    wrapper, args, kw = GATHER_EDGES[case](g, cuda)
    got = wrapper(*args, **kw)
    want = wrapper.reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gather_kernels_out_of_range_index_gives_nan(cuda):
    """An index past its table reads nothing and gives NaN (jnp's fill
    mode); the others are unaffected.  The loop sum: a negative index or a
    run past the table without mod, and (launched directly: the wrapper
    refuses it) a mod past the table's extent, whose sums are NaN exactly
    where the loop reaches an index outside the table; the single gather
    along axis 0; a table with no entry along the axis (the NaN fill), alone
    and in a loop; the vector take: a row past the table, a lane past the
    width, and a ragged last group."""
    from libre_tpu_torch.ops import _kernels

    table = torch.arange(16.0, device=cuda)
    idx = torch.tensor([3, 16, -1, 15], device=cuda, dtype=torch.int32)
    got = gather.take(table, idx).cpu()
    assert got[0] == 3.0 and got[3] == 15.0 and bool(got[1:3].isnan().all())
    lane = torch.tensor([1, 3, 4, -1], device=cuda, dtype=torch.int32)
    got = gather.take(table.reshape(4, 4), idx % 4, lane).cpu()
    assert got[0] == 13.0 and got[1] == 3.0 and bool(got[2:].isnan().all())
    idx = torch.tensor([[3, 8], [-1, 7]], device=cuda, dtype=torch.int32)
    got = gather.take_along(table.reshape(2, 8), idx, 1).cpu()
    assert got[0, 0] == 3.0 and got[1, 1] == 15.0 and bool(got[[0, 1], [1, 0]].isnan().all())
    # The single gather along axis 0 over 3 ragged lanes: rows 4 and 5 past
    # a 4-row table and -1 are NaN.
    idx = torch.tensor([[0, 4, 2], [-1, 3, 5]], device=cuda, dtype=torch.int32)
    got = gather.take_along(table[:12].reshape(4, 3), idx, 0).cpu()
    assert torch.equal(got[[0, 0, 1], [0, 2, 1]], torch.tensor([0.0, 8.0, 10.0]))
    assert bool(got[[0, 1, 1], [1, 0, 2]].isnan().all())
    # A table with no entry along the axis: every output NaN.
    got = gather.take_along(table.new_empty(3, 0), idx.new_zeros(3, 5), 1).cpu()
    assert got.shape == (3, 5) and bool(got.isnan().all())
    got = gather.take_along(table.new_empty(0, 5), idx.new_zeros(3, 5), 0, loop=4).cpu()
    assert got.shape == (3, 5) and bool(got.isnan().all())

    # The staged loop sum over (2, 40): a negative start and a run past the
    # end are NaN, the rest the plain sums.
    rows = torch.arange(80.0, device=cuda).reshape(2, 40)
    idx = torch.tensor([[-1, 0, 31, 32], [0, 5, 33, -7]], device=cuda, dtype=torch.int32)
    got = gather.take_along(rows, idx, 1, loop=9).cpu()
    bad = torch.tensor([[True, False, False, True], [False, False, True, True]])
    assert bool(got[bad].isnan().all()) and not bool(got[~bad].isnan().any())
    ok = idx.clamp(0, 31)
    want = gather.take_along_reference(rows, ok, 1, loop=9).cpu()
    assert torch.equal(got[~bad], want[~bad])
    # mod = 50 past the extent 40: from i the loop visits i .. min(i + 8,
    # 49) and wraps to 0; NaN iff that reaches 40.
    idx = torch.tensor([[0, 30, 35, 45], [49, 31, 20, -3]], device=cuda, dtype=torch.int32)
    out = torch.empty(idx.shape, device=cuda)
    _kernels.launch("probe_take_along", rows, idx, out, 2, 4, 2, 40, 1, 9, 50)
    got = out.cpu()
    table_np, idx_np = rows.cpu().numpy().astype(np.float64), idx.cpu().numpy()
    for r in range(2):
        for c in range(4):
            visits = [(int(idx_np[r, c]) % 50 + k) % 50 for k in range(9)]
            if max(visits) >= 40:
                assert bool(got[r, c].isnan()), (r, c, visits)
            else:
                acc = np.float32(0.0)
                for i in visits:
                    acc = np.float32(acc + np.float32(table_np[r, i]))
                assert float(got[r, c]) == float(acc), (r, c)
    # The vector take: rows of 4 (one float4 each), one past the table; a
    # lane past the width; 7 outputs (a ragged last group).
    got = gather.take(table.reshape(4, 4), torch.tensor([2, 4, 0], device=cuda,
                                                        dtype=torch.int32), row=4).cpu()
    assert torch.equal(got[[0, 2]], torch.tensor([[8.0, 9, 10, 11], [0, 1, 2, 3]]))
    assert bool(got[1].isnan().all())
    idx = torch.tensor([0, 1, 2, 3, 3, 2, 1], device=cuda, dtype=torch.int32)
    lane = torch.tensor([0, 1, 2, 3, 4, 3, 2], device=cuda, dtype=torch.int32)
    got = gather.take(table.reshape(4, 4), idx, lane).cpu()
    assert torch.equal(got[[0, 1, 2, 3, 5, 6]], torch.tensor([0.0, 5, 10, 15, 11, 6]))
    assert bool(got[4].isnan())


# --------------------------- the exit rule in K4, and the paths over it
@pytest.mark.cuda
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("field", FIELDS)
def test_exact_march_bwd_kernel_exit_rule(cuda, field, filter_mode):
    """K4 with the early exit on (0.999) vs its plain version at the
    bench_exact shape on every field, each gradient normalised by the
    plain one's max |·|: within the backward kernels' early-exit bound
    (a ray whose plain closed-form mask stops a sample apart from K3
    moves its gradient); rays exit, and K4 is one launch."""
    c = exact_grad_case("bench", seed=0, device=cuda, filter_mode=filter_mode, field=field,
                        early_exit=0.999)
    assert int((c.out[:, 3] > 0.999).sum()) > 0
    args = (c.volume, c.tf, c.view, c.out, c.g)
    launches = exact.march_exact_backward.launches
    got = exact.march_exact_backward(*args)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    assert exact.march_exact_backward.launches == launches + 1
    for i, (a, b) in enumerate(zip(got, want)):
        assert_grad_close(a, b, GRAD_TOL_MAX_EARLY_EXIT, GRAD_TOL_MEAN_EARLY_EXIT,
                          expect_zero=field == "top" and i == 0)


@pytest.mark.cuda
def test_volume_scene_on_card_matches_cpu(cuda):
    """``VolumeScene`` (K3 forward, K4 backward with the exit rule, early
    exit 0.999) on the card vs the plain versions on the CPU: the image
    (2e-3 / 1e-5, K3's bound) and the gradients of its mean square."""
    from libre_tpu_torch.models import VolumeScene
    from libre_tpu_torch.testing import smooth_volume

    vol = smooth_volume(16, seed=7, device="cpu")
    params = RenderParams(n_samples_per_ray=32, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear")
    camera, _ = build_camera(24, 24, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))
    results = []
    for dev in (cuda, "cpu"):
        scene = VolumeScene.from_volume(vol, params=params, device=dev)
        leaves = {k: v.clone().requires_grad_() for k, v in scene.parameters.items()}
        img = scene.with_parameters(leaves).render(camera)
        img.square().mean().backward()
        results.append((img.detach().cpu(), leaves["density"].grad.cpu(),
                        leaves["tf"].grad.cpu()))
    (img_c, dv_c, dt_c), (img_p, dv_p, dt_p) = results
    err = (img_c - img_p).abs()
    assert float(err.max()) <= EXACT_TOL_MAX and float(err.mean()) <= EXACT_TOL_MEAN
    assert float(img_p[..., 3].max()) > 0.999
    assert_grad_close(dv_c, dv_p, GRAD_TOL_MAX_EARLY_EXIT, GRAD_TOL_MEAN_EARLY_EXIT)
    assert_grad_close(dt_c, dt_p, GRAD_TOL_MAX_EARLY_EXIT, GRAD_TOL_MEAN_EARLY_EXIT)


@pytest.mark.cuda
def test_shearwarp_trainer_on_card_matches_cpu(cuda):
    """Two Adam steps of the dense shear-warp trainer (the plain pipeline,
    no kernel) on the card vs on the CPU: losses and both leaves within
    1e-4."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.transfer_function import default_color_map, grayscale_ramp
    from libre_tpu_torch.testing import smooth_volume
    from libre_tpu_torch.train import ShearWarpProblem, fit_shearwarp

    cams = [build_camera(32, 32, e, (0.0, 0.0, 0.0))[0]
            for e in ((0.2, 0.1, 1.4), (1.4, 0.1, 0.2))]
    problem = ShearWarpProblem.from_cameras(
        cams, [-0.5] * 3, [0.5] * 3,
        RenderParams(n_samples_per_ray=32, data_source_range=(0.0, 1.0)),
        sw.ShearWarpParams(n_planes=32, inter_size=(32, 32), classification="post"))
    truth = smooth_volume(32, seed=7, device="cpu")
    with torch.no_grad():
        targets = problem.render_views(None, truth, torch.from_numpy(default_color_map()))
    runs = []
    for dev in (cuda, "cpu"):
        params, losses = fit_shearwarp(problem, targets, np.full((32,) * 3, 0.5, np.float32),
                                       grayscale_ramp(), device=dev, steps=2)
        runs.append((losses, {k: v.detach().cpu() for k, v in params.items()}))
    (l_c, p_c), (l_p, p_p) = runs
    assert np.allclose(l_c, l_p, rtol=0, atol=1e-4) and l_p[1] < l_p[0]
    for k in p_p:
        assert float((p_c[k] - p_p[k]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_entry_on_card_matches_cpu(cuda):
    """``entry()`` on the card (K3) vs on the CPU (the plain march)."""
    from libre_tpu_torch.entry import entry

    fn, args = entry()
    assert args[0].device.type == "cuda"
    launches = exact.march_exact.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert exact.march_exact.launches == launches + 1
    fn_p, args_p = entry(device="cpu")
    err = (got.cpu() - fn_p(*args_p)).abs()
    assert float(err.max()) <= EXACT_TOL_MAX and float(err.mean()) <= EXACT_TOL_MEAN


# ------------------------------------------------- sharded (M9) on the card
def _logical_mesh(cuda, n_brick, n_ray):
    from libre_tpu_torch.parallel import make_mesh

    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[cuda] * (n_brick * n_ray))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("slabs", [False, True])
def test_sharded_k1_frame_on_logical_shards(cuda, shape, slabs):
    """``render_store_grid_sharded`` on four logical shards of the card:
    K1 launched once per shard, the fold within 2e-5 of the one-device
    frame (early exit off) and below 2e-3 with 0.999, replicated and in
    slab mode."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.parallel.bricked_sharded import render_store_grid_sharded, slab_ranges
    from libre_tpu_torch.testing import SHARD_TOL_EXIT_OFF, SHARD_TOL_EXIT_ON, smooth_volume

    store = smooth_volume(96, seed=3, device=cuda).permute(sw._PERM[2]).contiguous()
    tf = torch.from_numpy(default_color_map()).to(cuda)
    fv = swg.view_vector(world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2,
                         eye=[0.1, 0.05, 1.4], sign=-1.0, slope_bounds=(-0.45, 0.45, -0.4, 0.4),
                         inter_size=(128, 96), max_samples_per_ray=192)
    kw = dict(na_real=96, nc_real=96, nb_real=96, k_planes=192, inter_size=(128, 96),
              wb0=-0.5, wb1=0.5, wc0=-0.5, wc1=0.5)
    for exit_, tol in ((1.1, SHARD_TOL_EXIT_OFF), (0.999, SHARD_TOL_EXIT_ON)):
        one = render_store_grid_sharded(_logical_mesh(cuda, 1, 1), store, tf, fv,
                                        early_exit=exit_, **kw)
        extra = {}
        operand = store
        if slabs:
            lo, hi, _ = slab_ranges(fv, 96, 192, shape[0])
            operand = [store[lo[d]:hi[d] + 1].clone() for d in range(shape[0])]
            extra = {"a_base": lo}
        launches = swb.post_sweep.launches
        got = render_store_grid_sharded(_logical_mesh(cuda, *shape), operand, tf, fv,
                                        early_exit=exit_, **kw, **extra)
        torch.cuda.synchronize()
        assert swb.post_sweep.launches == launches + 4
        assert float((got - one).abs().max()) <= tol
        assert float(one[..., 3].max()) > 0.5


@pytest.mark.cuda
def test_store_train_step_reuses_sweep_tables(cuda, monkeypatch):
    """After its first step the store trainer's step builds no sweep
    tables on the card, and its loss equals, bit for bit, the loss of the
    same state from a loss function that rebuilds them on every call."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.testing import smooth_volume
    from libre_tpu_torch.train import store_trainer as st

    store = smooth_volume(64, seed=5, device=cuda).permute(sw._PERM[2]).contiguous()
    tf = torch.from_numpy(default_color_map()).to(cuda)
    views = np.stack([swg.view_vector(
        world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2, eye=e, sign=-1.0,
        slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(64, 48), max_samples_per_ray=128,
    ) for e in ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3])])
    problem = st.StoreProblem(
        views=views, na_store=64, na_real=64, nc_real=64, nb_real=64, k_planes=128,
        inter_size=(64, 48), world_min=np.float32([-0.5] * 3),
        world_max=np.float32([0.5] * 3), axis=2,
    )
    targets = (st.render_views(problem, store, tf) * 0.8 + 0.05).detach()
    params = {"store": torch.where(store > -0.5, 0.5, swb.SENTINEL).requires_grad_(),
              "tf": tf.clone().requires_grad_()}
    step = st.make_train_step(problem, torch.optim.Adam(list(params.values()), lr=3e-2))
    step(params, targets)
    with monkeypatch.context() as m, torch.no_grad():
        # The loss as it was: view vectors and tables made anew each call.
        m.setattr(st, "_view_operands",
                  lambda static, make_vs: lambda *key: (make_vs(*key), None))
        want = st.make_loss_fn(problem)(params["store"], params["tf"], targets)
    builds = swb.sweep_tables.builds
    got = step(params, targets)
    torch.cuda.synchronize()
    assert swb.sweep_tables.builds == builds
    assert torch.equal(got, want)
    assert float(got) > 0.0


@pytest.mark.cuda
def test_slab_loss_on_logical_shards(cuda):
    """The slab-sharded store loss on 4 × 1 logical shards of the card (K1
    and K2 once per shard) against the replicated loss on the card: loss
    rtol 1e-6, store and TF gradients 1e-5."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.testing import SHARD_GRAD_TOL, SHARD_LOSS_RTOL, smooth_volume
    from libre_tpu_torch.train import store_trainer as st

    store = smooth_volume(64, seed=5, device=cuda).permute(sw._PERM[2]).contiguous()
    tf = torch.from_numpy(default_color_map()).to(cuda)
    views = np.stack([swg.view_vector(
        world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2, eye=e, sign=-1.0,
        slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(64, 48), max_samples_per_ray=128,
    ) for e in ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3])])
    problem = st.StoreProblem(
        views=views, na_store=64, na_real=64, nc_real=64, nb_real=64, k_planes=128,
        inter_size=(64, 48), world_min=np.float32([-0.5] * 3),
        world_max=np.float32([0.5] * 3), axis=2,
    )
    targets = (st.render_views(problem, store, tf) * 0.8 + 0.05).detach()
    leaf, tf_one = store.clone().requires_grad_(), tf.clone().requires_grad_()
    one = st.make_loss_fn(problem)(leaf, tf_one, targets)
    one.backward()
    slabs = [s.requires_grad_() for s in st.shard_store_slabs_uniform(store, 4)]
    tf_slab = tf.clone().requires_grad_()
    k1, k2 = swb.post_sweep.launches, swg.store_grid_backward.launches
    loss = st.make_slab_loss_fn(problem, _logical_mesh(cuda, 4, 1))(slabs, tf_slab, targets)
    loss.backward()
    torch.cuda.synchronize()
    assert swb.post_sweep.launches == k1 + 8 and swg.store_grid_backward.launches == k2 + 8
    assert abs(loss.item() - one.item()) <= SHARD_LOSS_RTOL * abs(one.item())
    assert float((torch.cat([s.grad for s in slabs]) - leaf.grad).abs().max()) <= SHARD_GRAD_TOL
    assert float((tf_slab.grad - tf_one.grad).abs().max()) <= SHARD_GRAD_TOL


@pytest.mark.cuda
def test_sharded_exact_march_on_logical_shards(cuda):
    """``VolumeScene.render_sharded`` on 2 × 2 logical shards of the card:
    K3 once per shard, within K3's bound of the one-device render."""
    from libre_tpu_torch.models import VolumeScene
    from libre_tpu_torch.testing import smooth_volume

    cam, _fr = build_camera(64, 64, (0.3, 0.2, 1.4), (0.0, 0.0, 0.0))
    scene = VolumeScene.from_volume(smooth_volume(64, seed=2, device=cuda), device=cuda)
    with torch.no_grad():
        one = scene.render(cam)
        launches = exact.march_exact.launches
        got = scene.render_sharded(_logical_mesh(cuda, 2, 2), cam)
    torch.cuda.synchronize()
    assert exact.march_exact.launches == launches + 4
    err = (got - one).abs()
    assert float(err.max()) <= EXACT_TOL_MAX and float(err.mean()) <= EXACT_TOL_MEAN


@pytest.mark.cuda
def test_sharded_k5_sweep_on_logical_shards(cuda):
    """``shearwarp_dense.render_slope_grid_sharded`` on 2 × 2 logical
    shards of the card: K5 once per shard, within 2e-5 of the one-device
    sweep with the early exit off and below 2e-3 at 0.999."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.testing import SHARD_TOL_EXIT_OFF, SHARD_TOL_EXIT_ON, smooth_volume

    cam, _fr = build_camera(96, 96, (0.3, 0.2, 1.4), (0.0, 0.0, 0.0))
    plan = sw.make_plan(cam)
    vol = smooth_volume(64, seed=4, device=cuda)
    tf = torch.from_numpy(default_color_map()).to(cuda)
    chans = swd.classify_planes(vol, tf, plan.axis, (0.0, 1.0))
    nc, nb = chans.shape[1:3]
    for exit_, tol in ((1.1, SHARD_TOL_EXIT_OFF), (0.999, SHARD_TOL_EXIT_ON)):
        pa = swd.slope_grid_plan_args(
            plan, [-0.5] * 3, [0.5] * 3,
            RenderParams(n_samples_per_ray=128, data_source_range=(0.0, 1.0), early_exit=exit_),
            sw.ShearWarpParams(n_planes=128, inter_size=(96, 96)),
        )
        one = swd.render_classified_slope_grid(chans, nc, nb, pa)
        launches = swd.pre_sweep.launches
        got = swd.render_slope_grid_sharded(_logical_mesh(cuda, 2, 2), chans, nc, nb, pa)
        torch.cuda.synchronize()
        assert swd.pre_sweep.launches == launches + 4
        assert float((got - one).abs().max()) <= tol and float(one[..., 3].max()) > 0.5


# ------------------------------------------------- K4 over a brick set
@pytest.mark.cuda
@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("early_exit", [1.1, 0.999])
def test_exact_march_bwd_kernel_over_a_set(cuda, early_exit, filter_mode):
    """K4 over a brick set (``exact_set_grad_case``: 64 bricks of 20³
    with ghost voxels, front to back, two far-away pads) vs the plain set
    spec, one launch, each gradient normalised by the plain one's max
    |·|: within 1e-3 with the exit off, the early-exit bound with it on
    (rays exit); the pads take no gradient in either."""
    c = exact_set_grad_case(0, cuda, filter_mode=filter_mode, early_exit=early_exit)
    if early_exit <= 1.0:
        assert int((c.out[:, 3] > early_exit).sum()) > 0
    args = (c.volume, c.tf, c.view, c.out, c.g)
    launches = exact.march_exact_backward.launches
    got = exact.march_exact_backward(*args)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    assert exact.march_exact_backward.launches == launches + 1
    assert got[0].shape == c.volume.shape
    for a, b in zip(got, want):
        if early_exit > 1.0:
            assert_grad_close(a, b, EXACT_GRAD_TOL_MAX)
        else:
            assert_grad_close(a, b, GRAD_TOL_MAX_EARLY_EXIT, GRAD_TOL_MEAN_EARLY_EXIT)
    for d in (got[0], want[0]):
        assert float(d[-2:].abs().max()) == 0.0
        assert int((d[:-2].flatten(1).abs().amax(1) > 0).sum()) > 8


@pytest.mark.cuda
def test_exact_march_bwd_one_brick_set_is_the_brick_form(cuda):
    """K4 on the "bench" case as a (1, Z, Y, X) set equals its (Z, Y, X)
    launch within the kernel's bound (float atomics add in a run-dependent
    order), with the exit off and on."""
    for early_exit in (1.1, 0.999):
        c = exact_grad_case("bench", seed=0, device=cuda, early_exit=early_exit)
        one = exact.march_exact_backward(c.volume, c.tf, c.view, c.out, c.g)
        as_set = exact.march_exact_backward(c.volume[None], c.tf, c.view, c.out, c.g)
        torch.cuda.synchronize()
        assert as_set[0].shape == (1, *c.volume.shape)
        assert_grad_close(as_set[0][0], one[0], EXACT_GRAD_TOL_MAX)
        assert_grad_close(as_set[1], one[1], EXACT_GRAD_TOL_MAX)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tf", [1, 32, 255, 1024, 4096, 4097, 8192, 65536])
def test_exact_kernels_take_any_tf_size(cuda, n_tf):
    """K3 and K4 through their runtime-T instances (shared up to 4096
    entries, global past it, ``exact.tf_instance``): K3 on the scattered
    brick atlas (saturating TF, carry in, clip planes) within its bounds of
    the plain march; K4 on one brick and over a brick set, with the early
    exit off and on (0.999), within 1e-3 (normalised) of the plain
    backward, the TF gradient (T, 4); each launch counted on its instance."""
    kind = exact.tf_instance(n_tf)
    c = exact_case("bricks", seed=0, device=cuda, n_tf=n_tf)
    args = (c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params)
    launches = exact.march_exact.launches, exact.march_exact.instance_launches[kind]
    got = exact.march_exact(*args, max_steps=c.max_steps, width=c.width)
    want = exact.march_exact_reference(*args, max_steps=c.max_steps)
    torch.cuda.synchronize()
    assert (exact.march_exact.launches, exact.march_exact.instance_launches[kind]) == (
        launches[0] + 1, launches[1] + 1)
    err = (got - want).abs()
    assert float(err.max()) <= EXACT_TOL_MAX and float(err.mean()) <= EXACT_TOL_MEAN
    assert float(got[:, 3].max()) > 0.3
    for early_exit in (1.1, 0.999):
        for g in (exact_grad_case("wide", seed=0, device=cuda, n_tf=n_tf, early_exit=early_exit),
                  exact_set_grad_case(seed=0, device=cuda, n_tf=n_tf, early_exit=early_exit)):
            bwd = exact.march_exact_backward
            launches = bwd.launches, bwd.instance_launches[kind]
            got = bwd(g.volume, g.tf, g.view, g.out, g.g)
            want = exact.march_exact_backward_reference(g.volume, g.tf, g.view, g.out, g.g)
            torch.cuda.synchronize()
            assert (bwd.launches, bwd.instance_launches[kind]) == (launches[0] + 1,
                                                                   launches[1] + 1)
            assert got[1].shape == (n_tf, 4)
            if n_tf == 1:  # a flat lookup: no density gradient
                assert float(got[0].abs().max()) == 0.0 and float(want[0].abs().max()) == 0.0
            else:
                assert_grad_close(got[0], want[0], EXACT_GRAD_TOL_MAX)
            assert_grad_close(got[1], want[1], EXACT_GRAD_TOL_MAX)


@pytest.mark.cuda
def test_exact_kernels_refuse_a_tf_past_the_limit(cuda):
    """The old limit is gone: a CUDA TF past ``EXACT_TF_MAX`` entries
    renders through ``render_marcher_diff`` with K3 and K4 launched once
    each through their global instances, and matches the plain versions
    on the CPU: the image within K3's bounds, the gradients within 1e-3
    (normalised)."""
    c = exact_grad_case("wide", seed=0, device=cuda)
    big = torch.rand((exact.EXACT_TF_MAX + 1, 4), generator=torch.Generator().manual_seed(3))
    counts = (exact.march_exact.instance_launches["global"],
              exact.march_exact_backward.instance_launches["global"])
    results = []
    for dev in (cuda, "cpu"):
        view = dataclasses.replace(c.view, ray_pack=c.view.ray_pack.to(dev),
                                   brick_boxes=c.view.brick_boxes.to(dev))
        vol = c.volume.detach().to(dev).requires_grad_()
        tf = big.detach().to(dev).requires_grad_()
        out = exact.render_marcher_diff(vol, tf, view)
        (out * c.g.to(dev)).sum().backward()
        results.append((out.detach().cpu(), vol.grad.cpu(), tf.grad.cpu()))
    torch.cuda.synchronize()
    assert (exact.march_exact.instance_launches["global"],
            exact.march_exact_backward.instance_launches["global"]) == (counts[0] + 1,
                                                                       counts[1] + 1)
    (img_c, dv_c, dt_c), (img_p, dv_p, dt_p) = results
    err = (img_c - img_p).abs()
    assert float(err.max()) <= EXACT_TOL_MAX and float(err.mean()) <= EXACT_TOL_MEAN
    assert_grad_close(dv_c, dv_p, EXACT_GRAD_TOL_MAX)
    assert_grad_close(dt_c, dt_p, EXACT_GRAD_TOL_MAX)


@pytest.mark.cuda
@pytest.mark.parametrize("view", sorted(SWEEP_VIEWS))
def test_bf16_sweeps_bit_equal(cuda, view):
    """K1's and K5's bf16-resample instances bit-equal to their plain
    versions (``compute_dtype="bfloat16"``) on every seeded view, and
    apart from the f32 instances' frames."""
    store, tf, tables, clip, kw = sweep_case((96, 80, 128, 64, 48, 56), seed=0, device=cuda,
                                             view=view)
    got, t_got = swb.post_sweep(store, tf, tables, clip, **kw, compute_dtype="bfloat16")
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, **kw,
                                            compute_dtype="bfloat16")
    f32, _ = swb.post_sweep(store, tf, tables, clip, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(t_got, t_want)
    assert not torch.equal(got, f32)
    c = dense_case("sweep", seed=0, device=cuda, view=view)
    kw5 = dict(c.kw, compute_dtype="bfloat16")
    got = swd.pre_sweep(c.chans, c.tables, **kw5)
    want = swd.pre_sweep_reference(c.chans, c.tables, **kw5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not torch.equal(got, swd.pre_sweep(c.chans, c.tables, **c.kw))


@pytest.mark.cuda
def test_render_wall_tiles_bit_equal_on_card(cuda):
    """``render_wall`` on the card: each 2x2 tile bit-equal to the view's
    ``render_bricked`` frame, K1 launched once per view, the canvas on the
    card."""
    from libre_tpu_torch.benchmarks.demo_wall import layouts, make_view

    load_plugins()
    engine = RenderEngine(DataSource("mem://#64,64,64,32?pattern=gradient"),
                          max_gpu_cache_mb=256, device=cuda)
    tiles = layouts(128, 128)["2x2"]
    views = [(*make_view(vw, vh, az), (dx, dy)) for dx, dy, vw, vh, az in tiles]
    engine.render_wall(views, (128, 128), n_planes=64)
    launches = swb.post_sweep.launches
    canvas, stats = engine.render_wall(views, (128, 128), n_planes=64)
    torch.cuda.synchronize()
    assert swb.post_sweep.launches == launches + 4 and len(stats) == 4
    assert canvas.device.type == "cuda" and float(canvas[..., 3].max()) > 0.05
    for (dx, dy, vw, vh, _az), (cam, fr, _off) in zip(tiles, views):
        img, _ = engine.render_bricked(cam, fr, n_planes=64)
        assert torch.equal(canvas[dy : dy + vh, dx : dx + vw], img)


@pytest.mark.cuda
def test_sharded_exact_trainer_on_logical_shards(cuda):
    """One SGD step of the mesh-sharded exact trainer on 2 × 2 logical
    shards of the card against the same step on 1 × 1: K3 and K4 four
    times each, the loss within 1e-6 relative and the gradients within
    1e-5 (the one-device bounds of the sharded trainers)."""
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops.transfer_function import grayscale_ramp
    from libre_tpu_torch.parallel.render import shard_bricks_front_to_back
    from libre_tpu_torch.testing import (
        SHARD_GRAD_TOL,
        SHARD_LOSS_RTOL,
        smooth_volume,
        split_into_bricks,
    )
    from libre_tpu_torch.train import InverseRenderProblem, init_state, make_train_step

    cam, _fr = build_camera(64, 64, (0.3, 0.2, 1.4), (0.0, 0.0, 0.0))
    eye, dirs, cos_z, _ = ray_ops.make_rays(cam.inv_proj, cam.inv_mv, cam.viewport, device=cuda)
    dirs, tnp = dirs.reshape(-1, 3), ray_ops.near_plane_t(cos_z.reshape(-1), cam.near)
    bricks = split_into_bricks(smooth_volume(64, seed=3, device="cpu").numpy(), 4, 2,
                               device=cuda)
    sharded, _ = shard_bricks_front_to_back(bricks, eye.cpu().numpy(), 2)
    params = RenderParams(n_samples_per_ray=256, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear", early_exit=1.1)
    view = exact.exact_view(cam, params, bricks=bricks, device=cuda)
    problem = InverseRenderProblem(bricks=sharded, global_min=[-0.5] * 3,
                                   global_max=[0.5] * 3, params=params,
                                   max_steps=view.max_steps, width=64)
    with torch.no_grad():
        target = problem.render(_logical_mesh(cuda, 1, 1), sharded.data,
                                torch.from_numpy(grayscale_ramp()).to(cuda), eye, dirs, tnp)
    start = dataclasses.replace(
        problem, bricks=sharded._replace(data=torch.full_like(sharded.data, 0.5)))
    results = []
    for n_brick, n_ray in ((1, 1), (2, 2)):
        mesh = _logical_mesh(cuda, n_brick, n_ray)
        sgd = lambda ps: torch.optim.SGD(ps, lr=1.0)  # noqa: E731
        state = init_state(start, torch.from_numpy(grayscale_ramp()) * 0.8, sgd, mesh=mesh)
        launches = (exact.march_exact.launches, exact.march_exact_backward.launches)
        loss = make_train_step(start, sgd, mesh)(state, eye, dirs, tnp, target)
        torch.cuda.synchronize()
        counts = (exact.march_exact.launches - launches[0],
                  exact.march_exact_backward.launches - launches[1])
        assert counts == (n_brick * n_ray,) * 2, counts
        results.append((float(loss), torch.cat([d.grad for d in state.params["density"]]),
                        state.params["tf"].grad.clone()))
    (l1, d1, t1), (l4, d4, t4) = results
    assert abs(l4 - l1) <= SHARD_LOSS_RTOL * abs(l1) and l1 > 0
    assert float((d4 - d1).abs().max()) <= SHARD_GRAD_TOL and float(d1.abs().max()) > 0
    assert float((t4 - t1).abs().max()) <= SHARD_GRAD_TOL


# --------------------------------------- the trainers' update: the Adam kernel
def _assert_adam_close(opt_got, opt_want, got, want):
    """Each leaf and its moments within ``ADAM_TOL_ULPS`` f32 ulp of
    torch's: relative to the value, and for the leaf absolute to 1 (its
    range), for the moments to the moment's largest value (a lerp's sum
    can cancel)."""
    from libre_tpu_torch.testing import ADAM_TOL_ULPS

    tol = ADAM_TOL_ULPS * 2.0**-23
    for a, b in zip(got, want):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=tol, atol=tol)
        for key in ("exp_avg", "exp_avg_sq"):
            x, y = opt_got.state[a][key], opt_want.state[b][key]
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * float(y.abs().max()))
        assert float(opt_got.state[a]["step"]) == float(opt_want.state[b]["step"])


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["none", "clamp01", "pin"])
def test_adam_kernel_matches_torch_adam(cuda, epilogue):
    """Ten steps of ``step_optimizer`` over a 512³ leaf and a (256, 4) TF
    (the kernel, one launch a leaf a step, no fallback) against
    ``torch.optim.Adam``'s foreach step followed by the epilogue
    (``separate_passes``)."""
    from libre_tpu_torch.ops.adam import adam_update
    from libre_tpu_torch.train.update import separate_passes, step_optimizer

    gen = torch.Generator(device=cuda).manual_seed(11)
    p0 = torch.rand((512, 512, 512), device=cuda, generator=gen)
    if epilogue == "pin":
        p0[:, :, :64] = swb.SENTINEL
    tf0 = torch.rand((256, 4), device=cuda, generator=gen)
    got = [p0.clone().requires_grad_(), tf0.clone().requires_grad_()]
    want = [p0.clone().requires_grad_(), tf0.clone().requires_grad_()]
    del p0
    opt_got, opt_want = torch.optim.Adam(got, lr=0.3), torch.optim.Adam(want, lr=0.3)

    def epilogues(leaves):
        pin = [leaves[0]] if epilogue == "pin" else []
        return pin, [leaves[1]] + ([leaves[0]] if epilogue == "clamp01" else [])

    launches, fallbacks = adam_update.launches, step_optimizer.fallbacks
    for _ in range(10):
        for a, b in zip(got, want):
            b.grad = torch.randn(a.shape, device=cuda, generator=gen)
            a.grad = b.grad.clone()
        pin, clamp = epilogues(got)
        step_optimizer(opt_got, pin=pin, clamp=clamp)
        separate_passes(opt_want, *epilogues(want))
    torch.cuda.synchronize()
    assert adam_update.launches == launches + 20
    assert step_optimizer.fallbacks == fallbacks
    _assert_adam_close(opt_got, opt_want, got, want)
    if epilogue == "pin":
        assert bool((got[0].detach()[:, :, :64] == swb.SENTINEL).all())


@pytest.mark.cuda
def test_adam_kernel_tail_lr_edit_and_clear(cuda):
    """Leaves whose lengths are not multiples of 4 (one under 4), an ``lr``
    edited between steps and ``state.clear()`` mid-run, against torch;
    the wrapper refuses a leaf that is not 16 B aligned, and so does
    ``step_optimizer``: it never gives way to ``optimizer.step()`` on the
    card."""
    from libre_tpu_torch.ops.adam import adam_update
    from libre_tpu_torch.train.update import separate_passes, step_optimizer

    gen = torch.Generator(device=cuda).manual_seed(5)
    starts = [torch.rand(4 * 100_003 + 3, device=cuda, generator=gen),
              torch.rand(3, device=cuda, generator=gen)]
    got = [s.clone().requires_grad_() for s in starts]
    want = [s.clone().requires_grad_() for s in starts]
    opt_got, opt_want = torch.optim.Adam(got, lr=3e-2), torch.optim.Adam(want, lr=3e-2)
    fallbacks = step_optimizer.fallbacks
    for k in range(8):
        if k == 3:
            opt_got.param_groups[0]["lr"] = opt_want.param_groups[0]["lr"] = 0.2
        if k == 5:
            opt_got.state.clear()
            opt_want.state.clear()
        for a, b in zip(got, want):
            b.grad = torch.randn(a.shape, device=cuda, generator=gen)
            a.grad = b.grad.clone()
        step_optimizer(opt_got, clamp=[got[0]])
        separate_passes(opt_want, [], [want[0]])
    torch.cuda.synchronize()
    assert step_optimizer.fallbacks == fallbacks
    assert float(opt_got.state[got[0]]["step"]) == 3.0
    _assert_adam_close(opt_got, opt_want, got, want)

    base = torch.zeros(17, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        adam_update(base[1:], *(torch.zeros(16, device=cuda) for _ in range(3)), step=1,
                    lr=1e-2, betas=(0.9, 0.999), eps=1e-8)
    leaf = base[1:].requires_grad_()
    leaf.grad = torch.ones_like(leaf)
    launches = adam_update.launches
    with pytest.raises(ValueError, match="aligned"):
        step_optimizer(torch.optim.Adam([leaf], lr=1e-2))
    assert step_optimizer.fallbacks == fallbacks and adam_update.launches == launches
    assert bool((leaf.detach() == 0.0).all())


@pytest.mark.cuda
def test_trainers_take_the_adam_kernel(cuda):
    """Each trainer's step with a plain Adam on the card goes through the
    kernel: one launch a leaf, no fallback.  The store trainer's update is
    also held to ``torch.optim.Adam`` and the old epilogue given the same
    gradients: K2 sums with atomics, so two backward passes from one state
    differ in their last bits, and Adam's scale-free step turns the sign
    flips of near-zero gradients into moves of order lr; two runs of
    torch's own Adam from one start, each with its own backward, drift
    apart as far (0.17 by step 3 at lr 0.3 on an H100)."""
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops.adam import adam_update
    from libre_tpu_torch.ops.transfer_function import default_color_map, grayscale_ramp
    from libre_tpu_torch.testing import smooth_volume
    from libre_tpu_torch.train import (
        ShearWarpProblem,
        fit_shearwarp,
        init_exact_state,
        make_exact_train_step,
    )
    from libre_tpu_torch.train import store_trainer as st
    from libre_tpu_torch.train.update import separate_passes, step_optimizer

    def counted(run, leaves):
        launches, fallbacks = adam_update.launches, step_optimizer.fallbacks
        out = run()
        torch.cuda.synchronize()
        assert adam_update.launches == launches + leaves
        assert step_optimizer.fallbacks == fallbacks
        return out

    # The store trainer, one device and slabs over 4 x 1 logical shards.
    store = smooth_volume(64, seed=5, device=cuda).permute(sw._PERM[2]).contiguous()
    store[:, :, :8] = swb.SENTINEL
    tf = torch.from_numpy(default_color_map()).to(cuda)
    views = np.stack([swg.view_vector(
        world_min=[-0.5] * 3, world_max=[0.5] * 3, axis=2, eye=e, sign=-1.0,
        slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(64, 48), max_samples_per_ray=128,
    ) for e in ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3])])
    problem = st.StoreProblem(
        views=views, na_store=64, na_real=64, nc_real=64, nb_real=64, k_planes=128,
        inter_size=(64, 48), world_min=np.float32([-0.5] * 3),
        world_max=np.float32([0.5] * 3), axis=2,
    )
    targets = (st.render_views(problem, store, tf) * 0.8 + 0.05).detach()
    got = [store.clone().requires_grad_(), tf.clone().requires_grad_()]
    want = [store.clone().requires_grad_(), tf.clone().requires_grad_()]
    opt = torch.optim.Adam(got, lr=0.3)
    step = st.make_train_step(problem, opt)
    for _ in range(3):
        for a, b in zip(got, want):
            b.data.copy_(a.detach())
        ref = torch.optim.Adam(want, lr=0.3)
        ref.load_state_dict(copy.deepcopy(opt.state_dict()))
        counted(lambda: step({"store": got[0], "tf": got[1]}, targets), 2)
        for a, b in zip(got, want):
            b.grad = a.grad.clone()
        separate_passes(ref, [want[0]], [want[1]])
        _assert_adam_close(opt, ref, got, want)
    assert bool((got[0].detach()[:, :, :8] == swb.SENTINEL).all())

    slabs = [s.requires_grad_() for s in st.shard_store_slabs_uniform(store, 4)]
    tf_slab = tf.clone().requires_grad_()
    slab_step = st.make_slab_train_step(
        problem, torch.optim.Adam([*slabs, tf_slab], lr=3e-2), _logical_mesh(cuda, 4, 1))
    counted(lambda: slab_step({"slabs": slabs, "tf": tf_slab}, targets), 5)

    # The exact trainer, one brick.
    params = RenderParams(n_samples_per_ray=64, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear", early_exit=1.1)
    camera, _ = build_camera(24, 20, (0.1, 0.05, 1.4), (0.0, 0.0, 0.0))
    view = exact.exact_view(camera, params, device=cuda)
    truth = smooth_volume(32, seed=7, device=cuda)
    with torch.no_grad():
        target = exact.render_exact_diff(truth, torch.from_numpy(default_color_map()).to(cuda),
                                         view)
    state = init_exact_state(torch.full_like(truth, 0.5), default_color_map(),
                             lambda p: torch.optim.Adam(p, lr=5e-2), device=cuda)
    counted(lambda: make_exact_train_step(view)(state, target), 2)

    # The dense trainer.
    cams = [build_camera(32, 32, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))[0]]
    dense = ShearWarpProblem.from_cameras(
        cams, [-0.5] * 3, [0.5] * 3,
        RenderParams(n_samples_per_ray=32, data_source_range=(0.0, 1.0)),
        sw.ShearWarpParams(n_planes=32, inter_size=(32, 32), classification="post"))
    with torch.no_grad():
        dense_targets = dense.render_views(None, smooth_volume(32, seed=7, device="cpu"),
                                           torch.from_numpy(default_color_map()))
    counted(lambda: fit_shearwarp(dense, dense_targets, np.full((32,) * 3, 0.5, np.float32),
                                  grayscale_ramp(), device=cuda, steps=1), 2)


# ================================================================ TF lookup
def _tf_lookup_case(cuda, n_tf, shape, seed, flat=False):
    """A (n_tf, 4) TF, densities of ``shape`` (the edge cases of
    ``tf_lookup_densities`` first, then uniform draws over [−0.1, 1.1];
    all 0.5 when ``flat``) and a cotangent with a positive mean, on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = int(np.prod(shape))
    density = torch.rand(n, generator=gen, device=cuda) * 1.2 - 0.1
    edges = tf_lookup_densities(n_tf, seed, size=0).to(cuda)[:n]
    density[: edges.numel()] = edges
    if flat:
        density.fill_(0.5)
    tf = torch.from_numpy(tf_of_size(n_tf) * np.float32(0.8) + np.float32(0.1)).to(cuda)
    g = torch.rand(shape + (4,), generator=gen, device=cuda) * 2.0 - 0.5
    return tf, density.reshape(shape), g


@pytest.mark.cuda
@pytest.mark.parametrize("n_tf", TF_LOOKUP_SIZES)
def test_tf_lookup_forward_bit_equal(cuda, n_tf):
    """The kernel's forward equals ``lookup_reference`` on the card bit for
    bit: sizes off the float4 width, a strided and a misaligned density,
    the cell's 256³."""
    for shape in ((1,), (3,), (7, 9, 11), (4099,), (256, 256, 256)):
        tf, density, _g = _tf_lookup_case(cuda, n_tf, shape, seed=len(shape) + n_tf)
        got = tfm.lookup(tf, density)
        assert got.shape == density.shape + (4,) and got.dtype == torch.float32
        assert torch.equal(got, tfm.lookup_reference(tf, density)), shape
    tf, density, _g = _tf_lookup_case(cuda, n_tf, (33, 64), seed=1)
    for view in (density[:, ::2], density.reshape(-1)[1:], density.t()):
        assert torch.equal(tfm.lookup(tf, view), tfm.lookup_reference(tf, view))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_tf", TF_LOOKUP_SIZES)
@pytest.mark.parametrize("wants", [(True, True), (True, False), (False, True)],
                         ids=["both", "tf", "density"])
def test_tf_lookup_backward_matches_reference(cuda, n_tf, wants):
    """The kernel's backward against ``lookup_backward_reference`` within
    f32 round-off, for each gradient autograd can ask for: edge and uniform
    densities with a cotangent that is not contiguous; a flat 0.5 volume of
    the same size, every density in the same two bins and each thread's run
    a few densities of them (a lost run shows); the flat 0.5 at 256³, the
    contention case, where a lost block shows."""
    want_tf, want_density = wants
    cases = [_tf_lookup_case(cuda, n_tf, (5, 7, 119), seed=n_tf),
             _tf_lookup_case(cuda, n_tf, (5, 7, 119), seed=n_tf + 1, flat=True)]
    if n_tf in (256, 8192):
        cases.append(_tf_lookup_case(cuda, n_tf, (256, 256, 256), seed=2, flat=True))
    for k, (tf, density, g) in enumerate(cases):
        if k == 0:  # a strided cotangent
            g = torch.cat([g, g], dim=-2)[..., ::2, :]
            assert not g.is_contiguous()
        tf_leaf = tf.clone().requires_grad_(want_tf)
        dens_leaf = density.clone().requires_grad_(want_density)
        out = tfm.lookup(tf_leaf, dens_leaf)
        leaves = [t for t, w in ((tf_leaf, want_tf), (dens_leaf, want_density)) if w]
        grads = iter(torch.autograd.grad(out, leaves, g))
        got = (next(grads) if want_tf else None, next(grads) if want_density else None)
        want = lookup_backward_reference(tf, density, g)
        assert_tf_lookup_grads(got, want, tf_lookup_bounds(tf, density, g),
                               f"T={n_tf} case {k} {wants}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_tf_lookup_counts_its_launches(cuda):
    tf, density, g = _tf_lookup_case(cuda, 256, (64, 65), seed=4)
    tf.requires_grad_()
    before = tfm.lookup.launches
    out = tfm.lookup(tf, density)
    assert tfm.lookup.launches == before + 1
    out.backward(g)
    assert tfm.lookup.launches == before + 2
    with torch.no_grad():
        tfm.lookup(tf, density)
    assert tfm.lookup.launches == before + 3


@pytest.mark.cuda
def test_tf_lookup_rejects_what_the_kernel_does_not_take(cuda):
    tf, density, _g = _tf_lookup_case(cuda, 256, (16,), seed=5)
    before = tfm.lookup.launches
    with pytest.raises(TypeError):
        tfm.lookup(tf, density.double())
    with pytest.raises(TypeError):
        tfm.lookup(tf.half(), density)
    with pytest.raises(ValueError):
        tfm.lookup(tf.cpu(), density)
    with pytest.raises(ValueError):
        tfm.lookup(tf[:, :3], density)
    assert tfm.lookup.launches == before
