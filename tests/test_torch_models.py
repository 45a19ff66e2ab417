"""The port's ``models.VolumeScene`` against the JAX package's, on the CPU
(tests/test_models.py's scene: a smoothed 16³ volume, the 24² ``CAMERA``
of tests/test_reference_marcher.py, 32 samples per ray, trilinear, the
default early exit 0.999).

* the parameters round-trip, and ``interop.scene_params_from_jax`` maps
  the JAX scene's (1, Z, Y, X) brick to the port's (Z, Y, X);
* ``render`` against the JAX ``VolumeScene.render`` within 1e-5;
* the gradients of a seeded weighted sum of the image against
  ``jax.grad`` of the JAX scene (the XLA marcher with its exit mask), at
  the default early exit and on a dense field at 0.5 where most rays
  exit: within 1e-4 of the largest entry on the rays whose exit sample
  agrees; the rays whose exit moved by a sample (the two fold chunks in
  closed form, rounded differently) under 1% of the rays, their
  gradients within 1 − early_exit of the largest entry;
* ``render_sharded`` takes a ``parallel.mesh.Mesh`` (its images are held
  to the JAX scene's in tests/test_torch_parallel.py); a two-brick
  scene's gradients against ``jax.grad`` of the JAX scene's, by the same
  rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.models import VolumeScene as SceneJ
from libre_tpu.ops.reference import RenderParams as RenderParamsJ
from libre_tpu_torch import interop
from libre_tpu_torch.models import VolumeScene as SceneT
from libre_tpu_torch.ops.reference import Camera as CameraT
from libre_tpu_torch.ops.reference import RenderParams as RenderParamsT
from tests.test_reference_marcher import CAMERA, make_volume

torch.set_num_threads(1)

PARAMS = dict(n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode="trilinear")
CAMERA_T = CameraT(*CAMERA)
TOL_RENDER = 1e-5
TOL_GRAD = 1e-4


def scenes(seed=2, early_exit=None, dense=False):
    vol = make_volume(16, seed=seed)
    if dense:
        vol = (0.5 + 0.5 * vol).astype(np.float32)
    p = dict(PARAMS) if early_exit is None else dict(PARAMS, early_exit=early_exit)
    return (SceneJ.from_volume(vol, params=RenderParamsJ(**p)),
            SceneT.from_volume(vol, params=RenderParamsT(**p), device="cpu"))


def test_parameters_roundtrip():
    sj, st = scenes()
    p = st.parameters
    assert set(p) == {"density", "tf"}
    assert p["density"].shape == (1, 16, 16, 16) and p["tf"].shape == (256, 4)
    assert p["density"].shape == tuple(sj.parameters["density"].shape)
    st2 = st.with_parameters({"density": p["density"] * 2.0, "tf": p["tf"] * 0.5})
    assert torch.equal(st2.bricks.data, p["density"] * 2.0)
    assert torch.equal(st2.parameters["tf"], p["tf"] * 0.5)
    copied = interop.scene_params_from_jax(sj.parameters)
    np.testing.assert_array_equal(copied["density"], p["density"].numpy())
    np.testing.assert_array_equal(copied["tf"], p["tf"].numpy())
    assert st.max_steps() == sj.max_steps()
    with pytest.raises(ValueError, match="brick stack"):
        interop.scene_params_from_jax({"density": np.zeros((4, 4, 4)), "tf": p["tf"]})


def test_render_matches_jax():
    sj, st = scenes()
    want = np.asarray(sj.render(CAMERA))
    got = st.render(CAMERA_T)
    assert got.shape == (24, 24, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_RENDER)
    assert want[..., 3].max() > 0.5


def _grads(sj, st, g):
    """(port's, JAX's) (d_density (N, BZ, BY, BX), d_tf) of sum(image · g)."""
    g_img = g.reshape(24, 24, 4)

    def loss(params):
        return jnp.sum(sj.with_parameters(params).render(CAMERA) * g_img)

    want = interop.scene_params_from_jax(jax.grad(loss)(sj.parameters))
    leaves = {k: v.detach().clone().requires_grad_() for k, v in st.parameters.items()}
    (st.with_parameters(leaves).render(CAMERA_T) * torch.from_numpy(g_img)).sum().backward()
    return (leaves["density"].grad.numpy(), leaves["tf"].grad.numpy()), \
        (want["density"], want["tf"])


@pytest.mark.parametrize("case", ["default", "dense"])
def test_gradients_match_jax_with_early_exit(case):
    early_exit = {"default": None, "dense": 0.5}[case]
    sj, st = scenes(seed=4, early_exit=early_exit, dense=case == "dense")
    threshold = st.params.early_exit
    assert threshold == (0.999 if early_exit is None else early_exit)
    out_j = np.asarray(sj.render(CAMERA)).reshape(-1, 4)
    with torch.no_grad():
        out_t = st.render(CAMERA_T).reshape(-1, 4).numpy()
    exited = out_j[:, 3] > threshold
    assert exited.mean() > (0.5 if case == "dense" else 0.05), exited.mean()
    moved = (np.abs(out_t - out_j) > 2e-5).any(axis=1)  # the exit sample moved
    assert moved.sum() < 0.01 * moved.size, moved.sum()
    g = np.random.default_rng(0).random((out_j.shape[0], 4), dtype=np.float32)
    full = _grads(sj, st, g)
    agree = _grads(sj, st, g * (~moved)[:, None])
    off = _grads(sj, st, g * moved[:, None])
    for i in (0, 1):
        got, want = agree[0][i], agree[1][i]
        scale = np.abs(want).max()
        assert scale > 0.1
        assert np.abs(got - want).max() / scale <= TOL_GRAD
        assert np.abs(off[0][i] - off[1][i]).max() <= (1.0 - threshold) * np.abs(full[1][i]).max()
        assert np.abs(full[0][i]).sum() > 0


def test_render_sharded_raises():
    """``render_sharded`` takes only a ``Mesh``; a two-brick scene (the
    first two bricks of the 16³ volume in 2³ bricks with two ghost voxels,
    marched in storage order) renders as the JAX scene does, and its
    gradients match ``jax.grad`` of it on the rays whose exit sample
    agrees (the others under 1%)."""
    from libre_tpu_torch.testing import split_into_bricks
    from tests.test_reference_marcher import _split_into_bricks

    _sj, st = scenes()
    with pytest.raises(TypeError, match="Mesh"):
        st.render_sharded(object(), CAMERA_T)
    sj, st = scenes(seed=4)
    vol = make_volume(16, seed=4)
    two_j = jax.tree.map(lambda x: x[:2], _split_into_bricks(vol, 2, overlap=2))
    two_t = split_into_bricks(vol, 2, overlap=2, device="cpu")
    two_t = two_t._replace(**{k: getattr(two_t, k)[:2] for k in two_t._fields})
    sj, st = dataclasses.replace(sj, bricks=two_j), dataclasses.replace(st, bricks=two_t)
    assert st.parameters["density"].shape == (2, 12, 12, 12)
    out_j = np.asarray(sj.render(CAMERA)).reshape(-1, 4)
    with torch.no_grad():
        out_t = st.render(CAMERA_T).reshape(-1, 4).numpy()
    moved = (np.abs(out_t - out_j) > 2e-5).any(axis=1)
    assert moved.sum() < 0.01 * moved.size, moved.sum()
    assert out_j[:, 3].max() > 0.5
    g = np.random.default_rng(1).random((out_j.shape[0], 4), dtype=np.float32)
    (got_d, got_tf), (want_d, want_tf) = _grads(sj, st, g * (~moved)[:, None])
    for got, want in ((got_d, want_d), (got_tf, want_tf)):
        scale = np.abs(want).max()
        assert scale > 0.1
        assert np.abs(got - want).max() / scale <= TOL_GRAD
    assert np.abs(got_d[1]).max() > 0  # the second brick takes gradient
