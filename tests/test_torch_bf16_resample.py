"""The bf16 resample (``ShearWarpParams.compute_dtype="bfloat16"``) of the
sweeps on the CPU: the plain K1 (``post_sweep_reference`` through
``render_store_frame``) and the plain K5 (``pre_sweep_reference`` through
``render_classified_slope_grid``) against the JAX kernels in interpret mode
with the same ``compute_dtype``, from the four ``EYES`` of
tests/test_shearwarp_pallas.py (every major axis, both signs).

K1's scene is tests/test_torch_post_sweep.py's (32³, block 16, 24×20 rays,
64 planes), K5's tests/test_torch_shearwarp_dense.py's random scene.  On
these scenes the JAX bf16 frames lie 2.6e-3 to 6.2e-3 (max) from the JAX
f32 frames; each test asserts that gap is more than ten times its bound,
so that passing shows the rounding is the JAX kernels'.

Bounds.  K1: max 2e-5, mean 1e-6 (the f32 sweep's bound against the JAX
kernel; post-classification could move a sample across a TF bin, and the
mean would show it).  K5: mean 1e-5, and at most 1% of the values off by
more than 2e-5, none by more than 1e-3: XLA:CPU computes the JAX kernel's
axis lerp ``lo·(1 − w) + hi·w`` as one fused multiply-add, the port as two
rounded products and a sum (the f32 instance's arithmetic), so an f32 ulp
apart a value can round to the other bf16 neighbour: one bf16 ulp
(2⁻⁸ of the value) moves that pixel, on one of the four eyes.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import look_at, perspective
from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_bricked as swb_j
from libre_tpu.ops import shearwarp_pallas as swp_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from tests.test_bricked import GMAX, GMIN, fine_nodes, make_scene, upload_nodes
from tests.test_shearwarp_pallas import EYES
from tests.test_torch_shearwarp_dense import SWP, classified_pair, plan_args, random_scene

torch.set_num_threads(1)

K1_TOL = (2e-5, 1e-6)
K5_MEAN, K5_FLIP, K5_FLIP_SHARE, K5_MAX = 1e-5, 2e-5, 0.01, 1e-3
N_PLANES, INTER = 64, (24, 20)
IDS = ["z-", "x-", "y-", "z+"]


def cameras(eye):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at(eye, [0, 0, 0], [0, 1, 0])
    kw = dict(inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
              inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
              viewport=(0, 0, 24, 24), near=0.1)
    return CameraJ(**kw), CameraT(**kw)


@pytest.fixture(scope="module")
def bricked(tmp_path_factory):
    _vol, ds = make_scene(pathlib.Path(tmp_path_factory.mktemp("bf16_sweep")))
    nodes, _ = fine_nodes(ds)
    atlas, slot_of = upload_nodes(ds, nodes)
    return ds, nodes, atlas, slot_of


def k1_frames(bricked, eye, compute_dtype):
    """(port's, JAX's) slope grid of the store frame from ``eye``."""
    ds, nodes, atlas, slot_of = bricked
    cam_j, cam_t = cameras(eye)
    axis = sw_j.make_view_plan(cam_j).axis
    plan_j = swb_j.build_assembly_plan(ds, nodes, axis, slot_of, (0.0, 1.0))
    store_j = swb_j.assemble_store(atlas.data, plan_j)
    plan_t = interop.assembly_plan_from_jax(plan_j)
    store_t = torch.from_numpy(interop.store_from_jax(np.asarray(store_j), plan_t.fine_dims))
    tf = tf_j.default_color_map(256)
    want = np.asarray(swb_j.render_store_frame(
        store_j, plan_j, jnp.asarray(tf), cam_j,
        params=ParamsJ(n_samples_per_ray=N_PLANES, data_source_range=(0.0, 1.0)),
        swp=sw_j.ShearWarpParams(n_planes=N_PLANES, inter_size=INTER, classification="post",
                                 compute_dtype=compute_dtype),
        world_min=GMIN, world_max=GMAX, to_screen=False, interpret=True,
    ))
    got = swb_t.render_store_frame(
        store_t, plan_t, torch.from_numpy(tf), cam_t,
        params=ParamsT(n_samples_per_ray=N_PLANES, data_source_range=(0.0, 1.0)),
        swp=sw_t.ShearWarpParams(n_planes=N_PLANES, inter_size=INTER,
                                 compute_dtype=compute_dtype),
        world_min=GMIN, world_max=GMAX, to_screen=False,
    ).numpy()
    return got, want


@pytest.mark.parametrize("eye", EYES, ids=IDS)
def test_post_sweep_bf16_matches_jax(bricked, eye):
    got, want = k1_frames(bricked, eye, "bfloat16")
    _got32, want32 = k1_frames(bricked, eye, "float32")
    d = np.abs(got - want)
    assert d.max() <= K1_TOL[0] and d.mean() <= K1_TOL[1], (d.max(), d.mean())
    assert np.abs(want - want32).max() > 10 * K1_TOL[0]
    assert got[..., 3].max() > 0.1


def k5_frame(eye, compute_dtype):
    vol, tf = random_scene()
    pa_j, pa_t, _, _ = plan_args(eye, swp=dict(SWP, compute_dtype=compute_dtype))
    chans_j, content_j, chans_t, content_t, nc, nb = classified_pair(vol, tf, pa_j, pa_t)
    want = np.asarray(swp_j.render_classified_slope_grid(
        chans_j, nc, nb, pa_j, True, content=content_j))
    got = swd.render_classified_slope_grid(chans_t, nc, nb, pa_t, content=content_t)
    return got.numpy(), want


@pytest.mark.parametrize("eye", EYES, ids=IDS)
def test_pre_sweep_bf16_matches_jax(eye):
    got, want = k5_frame(eye, "bfloat16")
    _got32, want32 = k5_frame(eye, "float32")
    d = np.abs(got - want)
    assert d.mean() <= K5_MEAN and d.max() <= K5_MAX, (d.max(), d.mean())
    assert (d > K5_FLIP).mean() <= K5_FLIP_SHARE, (d > K5_FLIP).mean()
    gap = np.abs(want - want32)
    assert gap.max() > 10 * K5_MEAN and gap.mean() > 10 * K5_MEAN
    assert gap.max() > 2 * K5_MAX
    assert got[..., 3].max() > 0.1


def test_bf16_weights_and_edges():
    """``shearwarp.tap_weights`` under bf16: (1 − w) and w rounded one by
    one (their sum need not be 1), the clamped edge's one entry on tap
    i0, float32 untouched; a store sweep's gradient path ignores it."""
    w = torch.tensor([0.1, 0.3337, 0.5, 0.75, 0.123])
    i0 = torch.tensor([0, 1, 2, 7, 7])
    i1 = torch.tensor([1, 2, 3, 7, 7])
    w0, w1 = sw_t.tap_weights(i0, i1, w, "bfloat16")
    b = w.to(torch.bfloat16).float()
    assert torch.equal(w1[:3], b[:3]) and torch.equal(w1[3:], torch.zeros(2))
    assert torch.equal(w0[:3], (1.0 - w[:3]).to(torch.bfloat16).float())
    assert torch.equal(w0[3:], torch.ones(2))
    assert float((w0[:3] + w1[:3] - 1.0).abs().max()) > 0.0  # the rounded pair need not sum to 1
    f0, f1 = sw_t.tap_weights(i0, i1, w, "float32")
    assert torch.equal(f0, 1.0 - w) and torch.equal(f1, w)
    with pytest.raises(ValueError, match="compute_dtype"):
        sw_t.ShearWarpParams(compute_dtype="float16")
