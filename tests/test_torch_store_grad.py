"""The port's differentiable store render
(libre_tpu_torch.ops.shearwarp_grad.render_store_grid_diff) against the
JAX package's, on the tests/test_shearwarp_grad.py scene (N = 24,
16×12 rays, K = 40 planes).

The JAX side runs its Pallas forward and backward in interpret mode (and
its jnp recompute backward); the port runs on CPU tensors, so its
forward is ``post_sweep_reference`` and its backward
``store_grid_backward_reference``.  Tolerances: forward 2e-5 (the bound
the JAX package holds its kernel to); gradients, normalised by their max
|·|, 1e-4 against both JAX backwards and 3e-4 against torch autograd
through the plain forward (the bound test_shearwarp_grad.py holds the
JAX backward to against autodiff of its oracle).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_grad as swg_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops import shearwarp_grad as swg_t
from libre_tpu_torch.testing import field_volume, store_grad_case
from tests.test_shearwarp_grad import (
    BOUNDS, AXIS, GMAX, GMIN, K, N, PARAMS, U_SIZE, V_SIZE, oracle_fn, setup,
)

torch.set_num_threads(1)


def field_vol(field):
    """The scene's (N, N, N) volume as ``field_volume(field)``."""
    return field_volume(field, (N, N, N), seed=3, device="cpu").numpy()


def scene(tf_scale, diff_tf=True, field="random"):
    """(JAX operands, port operands) of the test_shearwarp_grad scene; a
    ``field`` other than "random" replaces its volume with
    ``field_vol(field)``."""
    vol, store_j, tf_j, vs_j, _ = setup(tf_scale=tf_scale)
    if field != "random":
        real = np.transpose(field_vol(field), sw_j._PERM[AXIS])
        store = np.array(store_j)
        store[: real.shape[0], : real.shape[1], : real.shape[2]] = real
        store_j = jnp.asarray(store)
    fine = vol.shape
    kw = dict(
        na_store=fine[0], na_real=fine[0], nc_real=fine[1], nb_real=fine[2],
        k_planes=K, v_size=V_SIZE, u_size=U_SIZE, world_min=GMIN,
        world_max=GMAX, axis=AXIS, early_exit=PARAMS.early_exit,
        diff_tf=diff_tf,
    )
    store_t = torch.from_numpy(interop.store_from_jax(np.asarray(store_j), fine))
    tf_t = torch.from_numpy(np.array(np.asarray(tf_j)))
    vs_t = torch.from_numpy(np.array(np.asarray(vs_j)))
    return (store_j, tf_j, vs_j, kw), (store_t, tf_t, vs_t, swg_t.static_view(**kw))


def cotangent():
    rng = np.random.default_rng(0)
    return rng.standard_normal((V_SIZE, U_SIZE, 4)).astype(np.float32)


def assert_close_normalised(got, want, atol):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("tf_scale", [1.0, 3.0])
def test_forward_matches_jax(tf_scale):
    (store_j, tf_j, vs_j, kw), (store_t, tf_t, vs_t, static) = scene(tf_scale)
    want = np.asarray(swg_j.render_store_grid_diff(
        store_j, tf_j, vs_j, swg_j.static_view(kc=16, interpret=True, **kw)
    ))
    got = swg_t.render_store_grid_diff(store_t, tf_t, vs_t, static).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if tf_scale == 3.0:
        assert got[..., 3].max() > PARAMS.early_exit  # the early exit fired


@pytest.mark.parametrize("backward", ["pallas", "jnp"])
@pytest.mark.parametrize("diff_tf", [True, False])
@pytest.mark.parametrize("tf_scale", [1.0, 3.0])
def test_gradients_match_jax(tf_scale, diff_tf, backward):
    """d_store and dtf through torch.autograd of the port == jax.grad of
    the JAX function with its Pallas or its jnp backward."""
    (store_j, tf_j, vs_j, kw), (store_t, tf_t, vs_t, static) = scene(
        tf_scale, diff_tf
    )
    g = cotangent()
    static_j = swg_j.static_view(kc=16, interpret=True, backward=backward, **kw)
    ds_j, dtf_j = jax.grad(
        lambda s, t: jnp.sum(
            swg_j.render_store_grid_diff(s, t, vs_j, static_j) * g
        ),
        argnums=(0, 1),
    )(store_j, tf_j)
    ds_j = interop.store_grad_from_jax(np.asarray(ds_j), tuple(store_t.shape))

    store = store_t.clone().requires_grad_()
    tf = tf_t.clone().requires_grad_()
    out = swg_t.render_store_grid_diff(store, tf, vs_t, static)
    (out * torch.from_numpy(g)).sum().backward()
    assert_close_normalised(store.grad.numpy(), ds_j, 1e-4)
    if diff_tf:
        assert_close_normalised(tf.grad.numpy(), np.asarray(dtf_j), 1e-4)
    else:
        assert tf.grad is None and np.abs(np.asarray(dtf_j)).max() == 0.0
    assert float(store.grad.abs().max()) > 0


@pytest.mark.parametrize("field", ["flat", "top", "smooth"])
def test_field_gradients_match_jax(field):
    """On a flat 0.5 volume (every sample in TF bins 127/128), a constant
    1.25 (bin 255, i0 == i1) and a smooth one (the bin moves every few
    samples): the plain K2's d_store and dtf == jax.grad of the JAX
    function with its Pallas backward in interpret mode (1e-4) and
    jax.grad of its plane oracle (3e-4, the bound test_shearwarp_grad.py
    holds the JAX backward to), each normalised by its max |·|."""
    (store_j, tf_j, vs_j, kw), (store_t, tf_t, vs_t, static) = scene(1.0, field=field)
    g = cotangent()
    static_j = swg_j.static_view(kc=16, interpret=True, backward="pallas", **kw)
    ds_j, dtf_j = jax.grad(
        lambda s, t: jnp.sum(swg_j.render_store_grid_diff(s, t, vs_j, static_j) * g),
        argnums=(0, 1),
    )(store_j, tf_j)
    ds_j = interop.store_grad_from_jax(np.asarray(ds_j), tuple(store_t.shape))
    oracle = oracle_fn((N, N, N))
    dv_o, dtf_o = jax.grad(
        lambda v, t: jnp.sum(oracle(v, t) * g), argnums=(0, 1)
    )(jnp.asarray(field_vol(field)), tf_j)
    ds_o = np.transpose(np.asarray(dv_o), sw_j._PERM[AXIS])

    store = store_t.clone().requires_grad_()
    tf = tf_t.clone().requires_grad_()
    (swg_t.render_store_grid_diff(store, tf, vs_t, static) * torch.from_numpy(g)).sum().backward()
    assert_close_normalised(store.grad.numpy(), ds_j, 1e-4)
    assert_close_normalised(tf.grad.numpy(), np.asarray(dtf_j), 1e-4)
    assert_close_normalised(store.grad.numpy(), ds_o, 3e-4)
    assert_close_normalised(tf.grad.numpy(), np.asarray(dtf_o), 3e-4)
    dtf = tf.grad.numpy()
    if field == "top":  # clamped: no density gradient, the TF's only in bin 255
        assert float(store.grad.abs().max()) == 0.0
        assert np.abs(dtf[:255]).max() == 0.0 and np.abs(dtf[255]).max() > 0
    elif field == "flat":
        assert np.abs(np.delete(dtf, [127, 128], axis=0)).max() == 0.0
        assert float(store.grad.abs().max()) > 0
    else:
        assert (np.abs(dtf).max(axis=1) > 0).sum() > 50  # many bins
        assert float(store.grad.abs().max()) > 0


@pytest.mark.parametrize("diff_tf", [True, False])
@pytest.mark.parametrize("tf_scale", [1.0, 3.0])
def test_gradients_match_autograd_of_plain_forward(tf_scale, diff_tf):
    """The recompute backward == torch.autograd through
    ``post_sweep_reference`` itself on the same scene."""
    _, (store_t, tf_t, vs_t, static) = scene(tf_scale, diff_tf)
    g = torch.from_numpy(cotangent())
    grads = []
    for plain in (False, True):
        store = store_t.clone().requires_grad_()
        tf = tf_t.clone().requires_grad_()
        if plain:
            tables = swb_t.sweep_tables(
                vs_t, na=static.na, k_planes=static.k_planes,
                v_size=static.v_size, u_size=static.u_size,
            )
            out, _ = swb_t.post_sweep_reference(
                store, tf, tables, torch.zeros((8, 4)), n_clip=0,
                wb=static.wb, wc=static.wc, early_exit=static.early_exit,
            )
        else:
            out = swg_t.render_store_grid_diff(store, tf, vs_t, static)
        (out * g).sum().backward()
        grads.append((store.grad.numpy(), tf.grad))
    (ds, dtf), (ds_ref, dtf_ref) = grads
    assert_close_normalised(ds, ds_ref, 3e-4)
    if diff_tf:
        assert_close_normalised(dtf.numpy(), dtf_ref.numpy(), 3e-4)
    else:
        assert dtf is None


@pytest.mark.parametrize("early_exit", [1.1, 0.999])
def test_backward_honours_carry_and_inactive_planes(early_exit):
    """On the seeded kernel case (SENTINEL holes, every 7th plane
    inactive) with a carry-in, the backward equals torch.autograd through
    ``post_sweep_reference``: it is that function's exact VJP."""
    store, tf, tables, _out, _t, g, kw = store_grad_case(
        (12, 10, 32, 48, 40, 44), seed=0, device="cpu", early_exit=early_exit
    )
    gen = torch.Generator().manual_seed(3)
    tables = dataclasses.replace(
        tables,
        rgb_in=0.3 * torch.rand((12, 10, 4), generator=gen),
        t_in=0.5 + 0.5 * torch.rand((12, 10), generator=gen),
    )
    s = store.clone().requires_grad_()
    t = tf.clone().requires_grad_()
    out, t_out = swb_t.post_sweep_reference(
        s, t, tables, torch.zeros((8, 4)), n_clip=0, **kw
    )
    (out * g).sum().backward()
    launches = swg_t.store_grid_backward.launches
    ds, dtf = swg_t.store_grid_backward(
        store, tf, tables, out.detach(), t_out.detach(), g, diff_tf=True, **kw
    )
    assert swg_t.store_grid_backward.launches == launches  # CPU: plain version
    assert_close_normalised(ds.numpy(), s.grad.numpy(), 1e-4)
    assert_close_normalised(dtf.numpy(), t.grad.numpy(), 1e-4)
    holes = store < -0.5
    assert bool(holes.any()) and float(ds[holes].abs().max()) == 0.0
    _, dtf_off = swg_t.store_grid_backward(
        store, tf, tables, out.detach(), t_out.detach(), g, diff_tf=False, **kw
    )
    assert float(dtf_off.abs().max()) == 0.0


def test_rejects_what_the_kernel_does_not_take():
    (_, _, _, kw), (store, tf, vs, static) = scene(1.0)
    with pytest.raises(ValueError, match="view vector"):
        swg_t.render_store_grid_diff(store, tf, torch.zeros(13), static)
    with pytest.raises(ValueError):
        swg_t.render_store_grid_diff(store[:-1], tf, vs, static)
    with pytest.raises(ValueError, match="k_total"):
        swg_t.static_view(**dict(kw, na_store=kw["na_store"] + 2))
    store_b, tf_b, tables, out, t_out, g, kw = store_grad_case(
        (6, 5, 8, 4, 5, 6), seed=0, device="cpu", early_exit=1.1
    )
    with pytest.raises(TypeError):
        swg_t.store_grid_backward(
            store_b, tf_b, tables, out, t_out, g.double(), diff_tf=True, **kw
        )
    with pytest.raises(ValueError):
        swg_t.store_grid_backward(
            store_b, tf_b, tables, out, t_out[:1], g, diff_tf=True, **kw
        )


def test_value_and_grad_through_screen_warp_matches_jax():
    """Training against a screen-space target: torch.autograd through
    ``render_store_grid_diff`` → ``warp_to_screen`` → mean(img²) equals
    jax.value_and_grad of the same chain in the JAX package
    (tests/test_shearwarp_grad.py::test_value_and_grad_through_screen_warp,
    its Pallas forward and backward in interpret mode): the loss within
    1e-6 relative, the store and TF gradients within 1e-4 normalised by
    their max |·|.  The warp's gradient is autograd's own: the port's
    ``warp_to_screen`` is plain PyTorch."""
    (store_j, tf_j, vs_j, kw), (store_t, tf_t, vs_t, static) = scene(1.0)
    u0, u1, v0, v1 = BOUNDS
    ug = np.linspace(u0, u1, U_SIZE, dtype=np.float32)
    vg = np.linspace(v0, v1, V_SIZE, dtype=np.float32)
    uu, vv = np.meshgrid(
        np.linspace(u0 + 0.05, u1 - 0.05, 8, dtype=np.float32),
        np.linspace(v0 + 0.05, v1 - 0.05, 8, dtype=np.float32),
        indexing="xy",
    )
    valid = np.ones_like(uu)
    grid = (ug, vg, uu, vv, valid)
    static_j = swg_j.static_view(kc=16, interpret=True, **kw)

    def loss_j(store_, tf_):
        inter = swg_j.render_store_grid_diff(store_, tf_, vs_j, static_j)
        return jnp.mean(sw_j.warp_to_screen(inter, *map(jnp.asarray, grid)) ** 2)

    val_j, (ds_j, dtf_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(store_j, tf_j)
    ds_j = interop.store_grad_from_jax(np.asarray(ds_j), tuple(store_t.shape))

    store = store_t.clone().requires_grad_()
    tf = tf_t.clone().requires_grad_()
    inter = swg_t.render_store_grid_diff(store, tf, vs_t, static)
    img = sw_t.warp_to_screen(inter, *map(torch.from_numpy, grid))
    loss = (img ** 2).mean()
    loss.backward()
    assert np.isfinite(float(loss.detach())) and img.shape == (8, 8, 4)
    np.testing.assert_allclose(float(loss.detach()), float(val_j), rtol=1e-6)
    assert float(store.grad.abs().max()) > 0 and float(tf.grad.abs().max()) > 0
    assert_close_normalised(store.grad.numpy(), ds_j, 1e-4)
    assert_close_normalised(tf.grad.numpy(), np.asarray(dtf_j), 1e-4)
