"""K4 over a brick set on the CPU: the port's plain
``raycast.march_exact_backward_reference`` (through
``exact.render_marcher_diff`` over the set, whose backward it is) against
``jax.grad`` of the JAX marcher ``raycast.render_rays`` over the same
bricks in the same order.

The scene: the 16³ smoothed volume of tests/test_reference_marcher.py in
2³ bricks with two ghost voxels (``_split_into_bricks``; the port's
``testing.split_into_bricks``), its 24² ``CAMERA``, 32 samples per ray,
a seeded cotangent; the bricks in front-to-back order or shuffled,
nearest and trilinear, the early exit off (1.1) and at 0.999, the
256-entry default colormap and a 32-entry one (the plain march and
backward at T ≠ 256, which the kernels do not take).  Tolerance: each
gradient within 1e-4 of its largest entry (``PERF.md`` §2).  With the exit on,
the rays whose exit sample moved by one (the two packages fold chunks in
closed form, rounded differently) are under 1% of the rays and are left
out of the cotangent, as in tests/test_torch_models.py.

Also: a one-brick set gives bit for bit what the (Z, Y, X) form gives; a
far-away pad brick of ``shard_bricks_front_to_back`` takes no sample and
no gradient and leaves the others' gradients as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.ops import raycast as raycast_j
from libre_tpu.ops import rays as rays_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as ParamsJ
from libre_tpu.ops.reference import max_steps_for_bricks
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops.reference import Camera as CameraT
from libre_tpu_torch.ops.reference import RenderParams as ParamsT
from libre_tpu_torch.testing import split_into_bricks
from tests.test_reference_marcher import CAMERA, GLOBAL_MAX, GLOBAL_MIN, _split_into_bricks, make_volume

torch.set_num_threads(1)

TOL_GRAD = 1e-4
CAMERA_T = CameraT(*CAMERA)
N_RAYS = CAMERA.viewport[2] * CAMERA.viewport[3]


def scene(seed=1):
    vol = make_volume(16, seed=seed)
    bricks_j = _split_into_bricks(vol, 2, overlap=2)
    bricks_t = split_into_bricks(vol, 2, overlap=2, device="cpu")
    eye, dirs, cos_z, _ = rays_j.make_rays(CAMERA.inv_proj, CAMERA.inv_mv, CAMERA.viewport)
    tnp = rays_j.near_plane_t(cos_z.reshape(-1), CAMERA.near)
    return bricks_j, bricks_t, eye, dirs.reshape(-1, 3), tnp


def params_pair(filter_mode, early_exit):
    kw = dict(n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode=filter_mode,
              early_exit=early_exit)
    return ParamsJ(**kw), ParamsT(**kw)


def port_set(bricks_t, order, params, tf):
    """The port's (out, d_data in the set's storage order, d_tf) of
    sum(out · g) over the bricks marched in ``order``, and the view."""
    ordered = bricks_t._replace(**{k: getattr(bricks_t, k)[order] for k in bricks_t._fields})
    view = exact.exact_view(CAMERA_T, params, GLOBAL_MIN, GLOBAL_MAX, bricks=ordered,
                            device="cpu")
    data = ordered.data.clone().requires_grad_()
    tf_t = torch.from_numpy(tf).requires_grad_()
    out = exact.render_marcher_diff(data, tf_t, view)

    def grads(g):
        data.grad = tf_t.grad = None
        (out * torch.from_numpy(g)).sum().backward(retain_graph=True)
        d_data = torch.zeros_like(data.grad)
        d_data[torch.as_tensor(order)] = data.grad
        return d_data.numpy(), tf_t.grad.numpy()

    return out.detach().numpy(), grads


def jax_set(bricks_j, order, params, tf, eye, dirs, tnp):
    """The JAX marcher's (out, grads(g)) over the same bricks in
    ``order``: jax.grad of sum(out · g), one compile for every g."""
    max_steps = max_steps_for_bricks(bricks_j.world_min, bricks_j.world_max, params.step_size)

    def loss(data, tf_, g):
        out = raycast_j.render_rays(
            bricks_j._replace(data=data), tf_, eye, dirs, tnp, params, GLOBAL_MIN, GLOBAL_MAX,
            brick_order=order, max_steps=max_steps,
        )
        return jnp.sum(out * g), out

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    tf_a = jnp.asarray(tf)

    def grads(g):
        (_, out), (d_data, d_tf) = fn(bricks_j.data, tf_a, jnp.asarray(g))
        return np.asarray(out), (np.asarray(d_data), np.asarray(d_tf))

    return grads


def assert_grads_close(got, want):
    for name, a, b in zip(("density", "tf"), got, want):
        scale = np.abs(b).max()
        assert scale > 0.05, (name, scale)
        err = np.abs(a - b).max() / scale
        assert err <= TOL_GRAD, (name, err)


# Two cases cover each choice (each case compiles the JAX marcher's
# gradient over 8 bricks, tens of seconds of XLA:CPU): the exit on, a
# 32-entry TF (the plain march and backward at T != 256) and a shuffled
# order with trilinear taps; the exit off, the 256-entry TF and the
# front-to-back order with nearest taps.
CASES = [("trilinear", 0.999, 32, "shuffled"), ("nearest", 1.1, 256, "sorted")]


@pytest.mark.parametrize("filter_mode,early_exit,n_tf,order_kind", CASES)
def test_set_gradient_matches_jax_grad(filter_mode, early_exit, n_tf, order_kind):
    bricks_j, bricks_t, eye, dirs, tnp = scene()
    p_j, p_t = params_pair(filter_mode, early_exit)
    tf = tf_j.default_color_map(n_tf)
    if order_kind == "sorted":
        order = raycast_j.sort_bricks_front_to_back(
            np.asarray(bricks_j.world_min), np.asarray(bricks_j.world_max), np.asarray(eye))
    else:
        order = np.random.default_rng(0).permutation(8)
    order = np.asarray(order, np.int64)
    out_t, port_grads = port_set(bricks_t, order, p_t, tf)
    jax_grads = jax_set(bricks_j, order, p_j, tf, eye, dirs, tnp)
    g = np.random.default_rng(2).random((N_RAYS, 4), dtype=np.float32)
    out_j, want = jax_grads(g)
    assert out_j[:, 3].max() > 0.5
    moved = (np.abs(out_t - out_j) > 2e-5).any(axis=1)
    if early_exit > 1.0:
        assert not moved.any(), np.abs(out_t - out_j).max()
    else:
        assert (out_j[:, 3] > early_exit).mean() > 0.05
        assert moved.sum() < 0.01 * moved.size, moved.sum()
        if moved.any():
            g = g * (~moved)[:, None]
            want = jax_grads(g)[1]
    got = port_grads(g)
    assert_grads_close(got, want)
    assert got[1].shape == (n_tf, 4)
    assert sum(np.abs(got[0][b]).max() > 0 for b in range(8)) >= 4  # the set is sampled


def test_one_brick_set_is_the_brick_form():
    """A (1, Z, Y, X) set and its box row give bit for bit the (Z, Y, X)
    form's march and gradients, the exit off and on."""
    vol = make_volume(16, seed=3)
    tf = torch.from_numpy(tf_j.default_color_map(256))
    g = torch.from_numpy(np.random.default_rng(4).random((N_RAYS, 4), dtype=np.float32))
    for early_exit in (1.1, 0.999):
        view = exact.exact_view(CAMERA_T, params_pair("trilinear", early_exit)[1], device="cpu")
        results = []
        for volume in (torch.from_numpy(vol), torch.from_numpy(vol)[None]):
            leaf = volume.clone().requires_grad_()
            tf_leaf = tf.clone().requires_grad_()
            out = exact.render_marcher_diff(leaf, tf_leaf, view)
            (out * g).sum().backward()
            results.append((out.detach(), leaf.grad.reshape(vol.shape), tf_leaf.grad))
        for a, b in zip(*results):
            assert torch.equal(a, b)


def test_pad_brick_takes_no_gradient():
    """A far-away pad brick (the boxes ``shard_bricks_front_to_back`` pads
    with) at the end and in the middle of the set: no sample, a zero
    gradient, the image and the real bricks' gradients bit for bit those
    of the set without it; ``max_steps`` stays the real bricks'."""
    _bj, bricks_t, _eye, _dirs, _tnp = scene(seed=5)
    _p_j, params = params_pair("trilinear", 1.1)
    tf = torch.from_numpy(tf_j.default_color_map(256))
    g = torch.from_numpy(np.random.default_rng(6).random((N_RAYS, 4), dtype=np.float32))
    base = exact.exact_view(CAMERA_T, params, GLOBAL_MIN, GLOBAL_MAX, bricks=bricks_t,
                            device="cpu")

    def run(bricks):
        view = exact.exact_view(CAMERA_T, params, GLOBAL_MIN, GLOBAL_MAX, bricks=bricks,
                                device="cpu")
        view = dataclasses.replace(view, max_steps=base.max_steps)
        leaf = bricks.data.clone().requires_grad_()
        out = exact.render_marcher_diff(leaf, tf, view)
        (out * g).sum().backward()
        return out.detach(), leaf.grad

    want_out, want_d = run(bricks_t)
    pad_min = torch.tensor([[1e8, 2e8, 3e8]])
    for at in (8, 3):
        def insert(x, row):
            return torch.cat([x[:at], row, x[at:]])

        padded = bricks_t._replace(
            data=insert(bricks_t.data, bricks_t.data[-1:]),
            world_min=insert(bricks_t.world_min, pad_min),
            world_max=insert(bricks_t.world_max, pad_min + 1e7),
            tex_min=insert(bricks_t.tex_min, bricks_t.tex_min[-1:]),
            tex_max=insert(bricks_t.tex_max, bricks_t.tex_max[-1:]),
        )
        out, d = run(padded)
        assert torch.equal(out, want_out)
        assert float(d[at].abs().max()) == 0.0
        assert torch.equal(torch.cat([d[:at], d[at + 1:]]), want_d)
