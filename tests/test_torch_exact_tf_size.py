"""The exact march and its gradient at any TF size T, on the CPU: the
port's plain K3 forward and plain K4 backward (``exact.render_marcher_diff``
over a brick set and over one (Z, Y, X) brick) against the JAX marcher
``raycast.render_rays`` and ``jax.grad`` of it, at T ∈ {1, 2, 32, 255,
1024, 4097, 8192} (past 4096 the kernels' global instances); ``VolumeScene``
trained two SGD steps at T = 32 against the JAX scene; no limit on T on
the card.

The scene is tests/test_torch_exact_set_grad.py's (the 16³ smoothed volume
of tests/test_reference_marcher.py, 2³ bricks with two ghost voxels, its
24² ``CAMERA``, 32 samples per ray, a seeded cotangent), marched front to
back with trilinear taps and the early exit off; the TF is the default
colormap at T entries (``testing.tf_of_size``: at one entry an opaque
colour).  Tolerances (``PERF.md`` §2): frames max 5e-5, mean
1e-5; gradients within 1e-4 of their largest entry (the TF gradient summed
in float64 by the plain version); the scene's parameters after two steps
within 1e-5.

The JAX references (``jax_reference``) run op by op (``jax.disable_jit``):
compiled, XLA:CPU contracts the TF coordinate clip(d)·T − 0.5 into one
fused multiply-add, which at a T that is no power of two (4097) moves s,
and so the lerp weight, by one f32 ulp (2.4e-4 past s = 2048) on about
0.08% of samples, and with it the TF gradient by 2.4e-4 of its largest
entry.  Op by op the reference rounds each operation as written, as the
port's plain version and its kernels (built without contraction) do.  The
density gradient is held against ``jax.grad`` of the marcher in float64
(``jax.enable_x64``): in float32 jax.grad differentiates the TF lerp
c0·(1 − w) + c1·w into g·c1 − g·c0, two roundings that do not cancel where
neighbouring entries differ by ~1/T, which at T = 8192 reach 1.07e-4 of
the density gradient's largest entry, where the port subtracts c1 − c0
exactly (3.7e-7 from float64).  The TF gradient stays against float32: it
moves with the f32 rounding of the TF coordinate, which the port shares.  The mesh-sharded exact trainer's steps at T = 32 are held
to the JAX trainer's in tests/test_torch_exact_sharded_trainer.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.models import VolumeScene as SceneJ
from libre_tpu.ops import raycast as raycast_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as RenderParamsJ
from libre_tpu_torch.models import VolumeScene as SceneT
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops.reference import RenderParams as RenderParamsT
from libre_tpu_torch.testing import tf_of_size
from tests.test_reference_marcher import CAMERA, _split_into_bricks, make_volume
from tests.test_torch_exact_set_grad import (
    CAMERA_T,
    N_RAYS,
    assert_grads_close,
    jax_set,
    params_pair,
    port_set,
    scene,
)

torch.set_num_threads(1)

TF_SIZES = (1, 2, 32, 255, 1024, 4097, 8192)
TOL_FRAME = (5e-5, 1e-5)
TOL_STEP = 1e-5


def assert_frames_close(got, want):
    err = np.abs(got - want)
    assert err.max() <= TOL_FRAME[0] and err.mean() <= TOL_FRAME[1], (err.max(), err.mean())


def check_grads(got, want, n_tf):
    """Both gradients within 1e-4 of their largest entry, the TF's (T, 4).
    At T = 1 every density reads the one entry: the lookup is flat, so
    the density gradient is exactly zero in both, and the TF's is all."""
    assert got[1].shape == (n_tf, 4)
    if n_tf == 1:
        assert np.abs(got[0]).max() == 0.0 and np.abs(want[0]).max() == 0.0
        scale = np.abs(want[1]).max()
        assert scale > 0.05 and np.abs(got[1] - want[1]).max() / scale <= 1e-4
        return
    assert_grads_close(got, want)


def jax_reference(bricks_j, order, p_j, tf, eye, dirs, tnp, g):
    """The JAX marcher's frame and TF gradient in float32 and its density
    gradient in float64, each op by op, over the bricks in ``order``
    (``jax_set``): (out, (d_data, d_tf))."""
    with jax.disable_jit():
        out_j, (_, d_tf) = jax_set(bricks_j, order, p_j, tf, eye, dirs, tnp)(g)
        with jax.enable_x64():
            b64 = bricks_j._replace(data=jnp.asarray(bricks_j.data, jnp.float64))
            _, (d_data, _) = jax_set(b64, order, p_j, tf.astype(np.float64), eye, dirs,
                                     tnp)(g.astype(np.float64))
    return out_j, (d_data, d_tf)


@pytest.mark.parametrize("n_tf", TF_SIZES)
def test_set_march_and_gradient_at_any_tf_size(n_tf):
    """Over the 8-brick set in front-to-back order."""
    bricks_j, bricks_t, eye, dirs, tnp = scene()
    p_j, p_t = params_pair("trilinear", 1.1)
    tf = tf_of_size(n_tf)
    order = np.asarray(raycast_j.sort_bricks_front_to_back(
        np.asarray(bricks_j.world_min), np.asarray(bricks_j.world_max), np.asarray(eye)),
        np.int64)
    out_t, port_grads = port_set(bricks_t, order, p_t, tf)
    g = np.random.default_rng(2).random((N_RAYS, 4), dtype=np.float32)
    out_j, want = jax_reference(bricks_j, order, p_j, tf, eye, dirs, tnp, g)
    assert out_j[:, 3].max() > 0.3
    assert_frames_close(out_t, out_j)
    check_grads(port_grads(g), want, n_tf)


@pytest.mark.parametrize("n_tf", TF_SIZES)
def test_brick_march_and_gradient_at_any_tf_size(n_tf):
    """One (Z, Y, X) brick filling the box (the exact trainer's form),
    against the JAX marcher over the same volume as a one-brick set."""
    vol = make_volume(16, seed=1)
    one_j = _split_into_bricks(vol, 1, overlap=0)
    _bj, _bt, eye, dirs, tnp = scene()
    p_j, p_t = params_pair("trilinear", 1.1)
    tf = tf_of_size(n_tf)
    view = exact.exact_view(CAMERA_T, p_t, device="cpu")
    leaf = torch.from_numpy(vol).requires_grad_()
    tf_t = torch.from_numpy(tf).requires_grad_()
    out = exact.render_marcher_diff(leaf, tf_t, view)
    g = np.random.default_rng(3).random((N_RAYS, 4), dtype=np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    out_j, (d_vol, d_tf) = jax_reference(one_j, np.zeros(1, np.int64), p_j, tf, eye, dirs,
                                         tnp, g)
    assert_frames_close(out.detach().numpy(), out_j)
    check_grads((leaf.grad.numpy(), tf_t.grad.numpy()), (d_vol[0], d_tf), n_tf)


def test_scene_two_steps_at_32_entries():
    """``VolumeScene`` from a 32-entry TF: two SGD steps (lr 0.5) on the
    MSE against a target image, density and TF, against the JAX scene's
    two steps by ``jax.grad``."""
    vol = make_volume(16, seed=2)
    tf = tf_j.default_color_map(32)
    p = dict(n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode="trilinear",
             early_exit=1.1)
    sj = SceneJ.from_volume(vol, tf=tf, params=RenderParamsJ(**p))
    st = SceneT.from_volume(vol, tf=tf, params=RenderParamsT(**p), device="cpu")
    target = np.array(SceneJ.from_volume(np.sqrt(vol), tf=tf, params=RenderParamsJ(**p))
                        .render(CAMERA))
    lr = 0.5

    def loss_j(params):
        return jnp.mean((sj.with_parameters(params).render(CAMERA) - target) ** 2)

    grad_j = jax.grad(loss_j)
    params_j = sj.parameters
    leaves = {k: v.detach().clone().requires_grad_() for k, v in st.parameters.items()}
    opt = torch.optim.SGD(leaves.values(), lr=lr)
    for _ in range(2):
        g = grad_j(params_j)
        params_j = {k: params_j[k] - lr * g[k] for k in params_j}
        opt.zero_grad()
        ((st.with_parameters(leaves).render(CAMERA_T) - torch.from_numpy(target)) ** 2) \
            .mean().backward()
        opt.step()
    assert leaves["tf"].shape == (32, 4)
    for k in ("density", "tf"):
        want = np.asarray(params_j[k])
        assert np.abs(want - np.asarray(sj.parameters[k])).max() > 1e-4  # the steps moved it
        np.testing.assert_allclose(leaves[k].detach().numpy(), want, rtol=0, atol=TOL_STEP)


def test_kernels_refuse_a_tf_past_the_limit():
    """The kernels' old limit is gone: off the CPU the kernels take any
    T ≥ 1.  On ``meta`` tensors (the check that runs before any launch)
    T = 4096, 4097 and 65 536 pass the operand check and meet only the
    device check; ``tf_instance`` names the instance each T runs (past
    ``EXACT_TF_MAX`` the global ones); the plain version on the CPU takes
    4097."""
    c = exact.EXACT_TF_MAX
    assert c == 4096
    assert [exact.tf_instance(t) for t in (1, 255, 256, 257, c, c + 1, 65536)] == [
        "shared", "shared", "fixed", "shared", "shared", "global", "global"]
    with pytest.raises(ValueError, match="at least one entry"):
        exact.tf_instance(0)
    _bj, bricks_t, _eye, _dirs, _tnp = scene()
    _p_j, p_t = params_pair("trilinear", 1.1)
    view = exact.exact_view(CAMERA_T, p_t, device="cpu")
    vol = torch.from_numpy(make_volume(16, seed=1))
    meta_view = view.__class__(**{**view.__dict__, "ray_pack": view.ray_pack.to("meta"),
                                  "brick_boxes": view.brick_boxes.to("meta")})
    out = torch.empty((N_RAYS, 4), device="meta")
    for n_tf in (c, c + 1, 65536):
        tf = torch.empty((n_tf, 4), device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            exact.march_exact_backward(vol.to("meta"), tf, meta_view, out, out)
        slots = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="no kernel for device meta"):
            exact.march_exact(vol[None].to("meta"), slots, meta_view.brick_boxes, tf,
                              meta_view.ray_pack, out, view.eye, p_t,
                              max_steps=view.max_steps)
    tf_big = torch.from_numpy(tf_j.default_color_map(c + 1))
    img = exact.render_marcher_diff(vol, tf_big, view)
    assert img.shape == (N_RAYS, 4) and float(img[:, 3].max()) > 0.3
