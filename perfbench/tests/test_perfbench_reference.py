"""The benchmark's plain references against the port's own plain versions
at a tiny size on the CPU: the view vectors and ray packs, the shear-warp
render and its gradients, the exact march and its gradients."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import exact as ref_exact
from perfbench.reference import shearwarp as ref_sw
from perfbench.reference.sinks import Sinks
from perfbench.reference.views import exact_rays, max_steps, shearwarp_view

ORBIT = {"poses": 3, "distance": 1.5, "height": 0.15, "azimuth_deg": [-10.0, 10.0],
         "jitter_deg": 1.25}
WMIN, WMAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)


def program_camera(cam):
    from libre_tpu_torch.ops.reference import Camera

    return Camera(cam["inv_proj"], cam["inv_mv"], cam["viewport"], cam["near"])


def store_case(seed, n=12, k=40, v=10, u=14):
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import shearwarp_bricked as swb

    cam = inputs.orbit(ORBIT, 20, 16, seed)[seed % 3]
    plan = sw.make_view_plan(program_camera(cam), 0.02)
    want = swb.view_vector(world_min=WMIN, world_max=WMAX, axis=plan.axis, eye=plan.eye,
                           sign=plan.sign, slope_bounds=plan.bounds, inter_size=(v, u),
                           max_samples_per_ray=32.0)
    got, axis, sign = shearwarp_view(cam, WMIN, WMAX, (v, u), 0.02, 32.0)
    assert (axis, sign) == (plan.axis, plan.sign)
    np.testing.assert_array_equal(got, want)
    store = inputs.gradient_store((n, n, n), 0.3 * seed, "cpu") * 0.9 + 0.05
    tables = swb.sweep_tables(torch.as_tensor(want), na=n, k_planes=k, v_size=v, u_size=u)
    tab = ref_sw.tables(torch.as_tensor(got), n, k, v, u)
    return store, tables, tab, {"wb": (-0.5, 0.5), "wc": (-0.5, 0.5)}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_shearwarp_render_and_gradients(seed):
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_grad as swg

    store, tables, tab, window = store_case(seed)
    tf = torch.from_numpy(inputs.default_color_map())
    clip = torch.zeros((swb.MAX_CLIP_PLANES, 4))
    kw = dict(wb=window["wb"], wc=window["wc"], early_exit=1.1)
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, n_clip=0, **kw)
    sinks = Sinks(store.numel(), 256, "cpu")
    got = ref_sw.render(store.reshape(-1), tuple(store.shape), tf, tab, window, sinks=sinks)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(seed))
    torch.sum(got * g).backward()
    d_store, d_tf = swg.store_grid_backward_reference(store, tf, tables, want, t_want, g,
                                                      diff_tf=True, **kw)
    scale = float(d_store.abs().max())
    assert float((sinks.volume.reshape(store.shape) - d_store).abs().max()) <= 1e-4 * scale
    scale = float(d_tf.abs().max())
    assert float((sinks.tf.float() - d_tf).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("early_exit", [1.1, 0.999])
def test_exact_rays_render_and_gradients(early_exit):
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops.reference import RenderParams

    n = 12
    cam = inputs.orbit(ORBIT, 14, 10, 5)[1]
    vol = inputs.smooth_volume(n, 5, "cpu")
    tf = torch.from_numpy(inputs.default_color_map())
    params = RenderParams(n_samples_per_ray=16, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear", early_exit=early_exit)
    view = exact.exact_view(program_camera(cam), params, device="cpu")
    step = 1.0 / 16
    rays = exact_rays(cam, step, WMIN, WMAX, "cpu")
    pack = view.ray_pack
    for row, key in ((3, "t_near_plane"), (4, "tn_global"), (5, "n_start")):
        torch.testing.assert_close(rays[key], pack[row], rtol=0, atol=0)
    torch.testing.assert_close(rays["dirs"], pack[:3].T, rtol=0, atol=0)
    cfg = {"step": step, "alpha_correction": 2.0, "early_exit": early_exit, "range": (0.0, 1.0),
           "box": (WMIN, WMAX), "max_steps": max_steps(WMIN, WMAX, step)}
    assert cfg["max_steps"] == view.max_steps
    counts = torch.zeros(pack.shape[1], dtype=torch.int64)
    got = ref_exact.render(vol, tf, rays, cfg, block=37, counts=counts)
    samples = torch.zeros(pack.shape[1], dtype=torch.int32)
    want = exact.march_exact(vol[None].contiguous(), torch.zeros(1, dtype=torch.int32),
                             view.brick_boxes, tf, pack, torch.zeros((pack.shape[1], 4)),
                             view.eye, params, max_steps=view.max_steps, samples=samples)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(counts, samples.long())
    if early_exit > 1.0:
        target = torch.rand(got.shape, generator=torch.Generator().manual_seed(3))
        sinks = Sinks(vol.numel(), 256, "cpu")
        ref_exact.loss_and_grads(vol, tf, rays, target, cfg, sinks, block=37)
        g = 2.0 * (want - target) / want.numel()
        d_vol, d_tf = exact.march_exact_backward(vol, tf, view, want, g)
        for mine, theirs in ((sinks.volume.reshape(vol.shape), d_vol), (sinks.tf.float(), d_tf)):
            assert float((mine - theirs).abs().max()) <= 1e-4 * float(theirs.abs().max())
