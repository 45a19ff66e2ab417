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
from libre_tpu_torch.render.engine import RenderEngine
from libre_tpu_torch.testing import KERNEL_TOL_MAX, KERNEL_TOL_MEAN, sweep_case


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
    early-exit test moves a pixel by at most 1 − 0.999), mean 1e-5 (FMA
    contraction)."""
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
