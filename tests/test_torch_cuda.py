"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips where torch sees no GPU.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from libre_tpu.data.datasource import DataSource, load_plugins
from libre_tpu_torch.apps.render_cli import build_camera
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.render.engine import RenderEngine
from libre_tpu_torch.testing import (
    GRAD_TOL_MAX,
    GRAD_TOL_MAX_EARLY_EXIT,
    GRAD_TOL_MEAN_EARLY_EXIT,
    KERNEL_TOL_MAX,
    KERNEL_TOL_MEAN,
    store_grad_case,
    sweep_case,
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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
