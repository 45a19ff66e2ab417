"""The port's exact backward (``exact.render_exact_diff`` on the CPU, whose
backward runs ``raycast.march_exact_backward_reference``, the plain
version of K4) against the JAX package, with the early exit off.

The same seeded numpy inputs (a 16³ random volume, the default TF, 16²
rays, 32 samples per ray, a random cotangent; the scene of
tests/test_exact_pallas.py:281-326) go through:

* ``jax.grad`` of the JAX oracle ``reference.render_reference``;
* ``jax.grad`` of JAX ``exact_pallas.render_exact_diff`` in interpret mode
  (its recompute-backward Pallas kernel), except for the brick whose b
  extent exceeds 128, where that kernel drops density gradients at b ≥ 128
  (ROADMAP queue 3), so the oracle alone is the target;
* torch autograd of the port's own oracle ``reference.render_reference``.

Tolerances: the JAX suite's density 1e-4 and TF 1e-3 absolute
(test_exact_pallas.py:321-326); the TF one is tightened to 5e-4.  The
largest differences seen on these cases, against either JAX target, are
5.9e-5 (density, nearest) and 1.7e-4 (TF, opposite sign), on gradients of
O(1); the JAX oracle and the JAX Pallas kernel differ from each other by
as much (5.9e-5, 1.1e-4).  A random volume amplifies rounding: an ulp of a
sample position (XLA:CPU contracts multiply-adds, PyTorch does not) moves
the fetched density by ~1e-5 at 16 voxels per unit and the TF lerp weight
by 256 times that.  So the b > 128 brick, at 136 voxels per unit, takes a
smooth field (there a uniform random volume put the JAX oracle 1.4e-3
off both the port's backward and torch autograd of the port's oracle in
the TF gradient; the smooth field leaves 2.8e-5 and 4.3e-5).  The
jittered case hands both packages the port's jitter grid
(``shared_jitter``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libre_tpu.ops import exact_pallas as ep_j
from libre_tpu.ops import reference as ref_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu_torch.ops import exact
from libre_tpu_torch.ops import rays as rays_t
from libre_tpu_torch.ops import reference as ref_t
from libre_tpu_torch.testing import field_volume
from tests.test_torch_exact import cameras, shared_jitter

torch.set_num_threads(1)

GMIN = np.float32([-0.5, -0.5, -0.5])
GMAX = np.float32([0.5, 0.5, 0.5])
ATOL_DENSITY = 1e-4
ATOL_TF = 5e-4
CLIP = np.float32([[0.0, 0.0, 1.0, 0.2], [1.0, 0.0, 0.0, 0.3]])


def smooth_field(shape, rng):
    """A smooth random f32 field in [0.1, 0.9]: six random plane waves of
    at most 3 periods across the box."""
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in shape]
    z, y, x = np.meshgrid(*axes, indexing="ij")
    field = np.zeros(shape, np.float32)
    for _ in range(6):
        kz, ky, kx = rng.uniform(-3.0 * np.pi, 3.0 * np.pi, 3).astype(np.float32)
        field += np.sin(kz * z + ky * y + kx * x + np.float32(rng.uniform(0, 2 * np.pi)))
    field = (field - field.min()) / (field.max() - field.min())
    return (0.1 + 0.8 * field).astype(np.float32)


def scene(filter_mode="trilinear", shape=(16, 16, 16), spr=32, img=16, seed=0, smooth=False):
    """(volume, TF, cotangent (img², 4), JAX params, port params); the
    volume is uniform random, or ``smooth_field``."""
    rng = np.random.default_rng(seed)
    vol = smooth_field(shape, rng) if smooth else rng.random(shape, dtype=np.float32)
    tf = tf_j.default_color_map(256)
    gw = rng.random((img * img, 4), dtype=np.float32)
    kw = dict(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode=filter_mode, early_exit=1.1,
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * spr)) + 4,
    )
    return vol, tf, gw, ref_j.RenderParams(**kw), ref_t.RenderParams(**kw)


def port_grads(vol, tf, gw, camera, params, clip=None, sample_index=0):
    """(out, d_volume, d_tf) of sum(render_exact_diff · gw) on the CPU."""
    v = torch.from_numpy(vol).requires_grad_()
    t = torch.from_numpy(tf).requires_grad_()
    view = exact.exact_view(
        camera, params, GMIN, GMAX, clip_planes=clip, sample_index=sample_index,
        device="cpu",
    )
    launches = exact.march_exact_backward.launches
    out = exact.render_exact_diff(v, t, view)
    (out * torch.from_numpy(gw)).sum().backward()
    assert exact.march_exact_backward.launches == launches  # the CPU runs no kernel
    return out.detach().numpy(), v.grad.numpy(), t.grad.numpy()


def oracle_grads(vol, tf, gw, camera, params, clip=None):
    def loss(v, t):
        out = ref_j.render_reference(
            ref_j.single_brick_set(v), t, camera, params, GMIN, GMAX, clip_planes=clip
        )
        return jnp.sum(out.reshape(-1, 4) * gw)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))]


def pallas_grads(vol, tf, gw, camera, params, clip=None, sample_index=0):
    plan = ep_j.plan_exact(
        camera, params, GMIN, GMAX, vol.shape, clip_planes=clip, sample_index=sample_index
    )

    def loss(v, t):
        return jnp.sum(ep_j.render_exact_diff(v, t, plan, True) * gw)

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.asarray(vol), jnp.asarray(tf))]


def assert_grads_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL_DENSITY)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL_TF)


CASES = {
    # name: (filter mode, eye, clip planes); tests/test_exact_pallas.py:281-289
    # and a clip-plane case
    "trilinear": ("trilinear", [0.25, 0.12, 1.4], None),
    "nearest": ("nearest", [0.25, 0.12, 1.4], None),
    "x_axis": ("trilinear", [1.4, 0.1, 0.2], None),
    "opposite_sign": ("trilinear", [0.1, 0.15, -1.4], None),
    "clip_planes": ("trilinear", [0.25, 0.12, 1.4], CLIP),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax(case):
    """Density and TF gradients vs the JAX oracle and the JAX Pallas
    backward (interpret mode)."""
    filter_mode, eye, clip = CASES[case]
    vol, tf, gw, p_j, p_t = scene(filter_mode)
    cam_j, cam_t = cameras(eye, img=16)
    out, *got = port_grads(vol, tf, gw, cam_t, p_t, clip)
    want = oracle_grads(vol, tf, gw, cam_j, p_j, clip)
    assert_grads_close(got, want)
    assert_grads_close(got, pallas_grads(vol, tf, gw, cam_j, p_j, clip))
    assert np.abs(want[0]).max() > 0.1 and np.abs(want[1]).max() > 0.1
    assert out[:, 3].max() > 0.1


@pytest.fixture()
def jax_takes_port_jitter(monkeypatch):
    """The JAX package's rays and its exact kernels' jitter take the
    port's jitter grid; its kernel caches are emptied around the test so
    no frame function built on its own grid is reused."""
    shared_jitter(monkeypatch)
    monkeypatch.setattr(
        ep_j, "_jitter_frag", lambda viewport, i: rays_t.jitter_frag(tuple(viewport), i)
    )
    caches = (ep_j._compiled_group, ep_j._compiled_group_bwd)
    for c in caches:
        c.cache_clear()
    yield
    for c in caches:
        c.cache_clear()


def test_jittered_sample_matches_jax(jax_takes_port_jitter):
    """Subpixel sample 1: the port's view vs a JAX plan of the same
    sample; and the mean of samples 0 and 1 vs the oracle at 2 samples per
    pixel."""
    vol, tf, gw, p_j, p_t = scene()
    cam_j, cam_t = cameras([0.25, 0.12, 1.4], img=16)
    _, *got1 = port_grads(vol, tf, gw, cam_t, p_t, sample_index=1)
    assert_grads_close(got1, pallas_grads(vol, tf, gw, cam_j, p_j, sample_index=1))
    _, *got0 = port_grads(vol, tf, gw, cam_t, p_t, sample_index=0)
    assert np.abs(got1[0] - got0[0]).max() > 1e-3  # the jitter moved the rays
    p2 = dataclasses.replace(p_j, samples_per_pixel=2)
    want = oracle_grads(vol, tf, gw, cam_j, p2)
    assert_grads_close([(a + b) / 2 for a, b in zip(got0, got1)], want)


def test_wide_brick_matches_oracle():
    """A (16, 136, 136) brick seen down z: both extents across the march
    exceed 128, where the JAX Pallas backward drops the density gradient
    at b ≥ 128; the oracle is the target, and the gradient there is not
    zero."""
    vol, tf, gw, p_j, p_t = scene(shape=(16, 136, 136), smooth=True)
    cam_j, cam_t = cameras([0.25, 0.12, 1.4], img=16)
    _, *got = port_grads(vol, tf, gw, cam_t, p_t)
    want = oracle_grads(vol, tf, gw, cam_j, p_j)
    assert_grads_close(got, want)
    assert np.abs(want[0][:, :, 128:]).max() > 1e-3
    assert np.abs(got[0][:, :, 128:]).max() > 1e-3


@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
@pytest.mark.parametrize("field", ["flat", "top", "smooth"])
def test_field_backward_matches_jax(field, filter_mode):
    """On a flat 0.5 volume (every sample in TF bins 127/128), a constant
    1.25 (bin 255, i0 == i1, no density gradient) and a smooth one (the
    bin moves every few samples): the plain K4 vs the JAX oracle and the
    JAX Pallas backward (interpret mode), at the tolerances above."""
    vol, tf, gw, p_j, p_t = scene(filter_mode)
    vol = field_volume(field, vol.shape, seed=0, device="cpu").numpy()
    cam_j, cam_t = cameras([0.25, 0.12, 1.4], img=16)
    out, *got = port_grads(vol, tf, gw, cam_t, p_t)
    assert_grads_close(got, oracle_grads(vol, tf, gw, cam_j, p_j))
    assert_grads_close(got, pallas_grads(vol, tf, gw, cam_j, p_j))
    d_vol, d_tf = got
    assert out[:, 3].max() > 0.1
    if field == "top":
        assert np.abs(d_vol).max() == 0.0
        assert np.abs(d_tf[:255]).max() == 0.0 and np.abs(d_tf[255]).max() > 0
    elif field == "flat":
        assert np.abs(np.delete(d_tf, [127, 128], axis=0)).max() == 0.0
        assert np.abs(d_vol).max() > 0
    else:
        assert (np.abs(d_tf).max(axis=1) > 0).sum() > 50 and np.abs(d_vol).max() > 0


def test_tf_without_grad():
    """A TF that needs no gradient: ``render_exact_diff`` gives the same
    d_volume and leaves ``tf.grad`` None; the plain K4 and its wrapper
    with ``diff_tf=False`` give that d_volume and a zero d_tf."""
    vol, tf, gw, _p_j, p_t = scene()
    _cam_j, cam_t = cameras([0.25, 0.12, 1.4], img=16)
    view = exact.exact_view(cam_t, p_t, GMIN, GMAX, device="cpu")
    g = torch.from_numpy(gw)
    grads = []
    for tf_needs_grad in (True, False):
        v = torch.from_numpy(vol).requires_grad_()
        t = torch.from_numpy(tf).requires_grad_(tf_needs_grad)
        (exact.render_exact_diff(v, t, view) * g).sum().backward()
        grads.append((v.grad, t.grad))
    (dv_on, dtf_on), (dv_off, dtf_off) = grads
    assert dtf_off is None and float(dtf_on.abs().max()) > 0.1
    assert torch.equal(dv_on, dv_off)
    with torch.no_grad():
        out = exact.render_exact_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)
    args = (torch.from_numpy(vol), torch.from_numpy(tf), view, out, g)
    for backward in (exact.march_exact_backward_reference, exact.march_exact_backward):
        dv, dtf = backward(*args, diff_tf=False)
        assert torch.equal(dv, dv_on) and float(dtf.abs().max()) == 0.0
        dv, dtf = backward(*args)
        assert torch.equal(dv, dv_on) and torch.equal(dtf, dtf_on)


@pytest.mark.parametrize("filter_mode", ["nearest", "trilinear"])
def test_autograd_matches_port_oracle(filter_mode):
    """render_exact_diff's gradients vs torch autograd of the port's own
    per-sample oracle."""
    vol, tf, gw, _p_j, p_t = scene(filter_mode)
    _cam_j, cam_t = cameras([0.2, 0.1, 1.4], img=16)
    out, *got = port_grads(vol, tf, gw, cam_t, p_t)
    v = torch.from_numpy(vol).requires_grad_()
    t = torch.from_numpy(tf).requires_grad_()
    want_out = ref_t.render_reference(ref_t.single_brick_set(v), t, cam_t, p_t, GMIN, GMAX)
    (want_out.reshape(-1, 4) * torch.from_numpy(gw)).sum().backward()
    np.testing.assert_allclose(out, want_out.detach().reshape(-1, 4).numpy(), rtol=0, atol=1e-5)
    assert_grads_close(got, [v.grad.numpy(), t.grad.numpy()])


def test_early_exit_must_be_off():
    vol, tf, _gw, _p_j, p_t = scene()
    _cam_j, cam_t = cameras([0.2, 0.1, 1.4], img=16)
    for early_exit in (0.999, 1.0):
        params = dataclasses.replace(p_t, early_exit=early_exit)
        view = exact.exact_view(cam_t, params, GMIN, GMAX, device="cpu")
        with pytest.raises(ValueError, match="early_exit"):
            exact.render_exact_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)


def test_backward_rejects_bad_operands():
    vol, tf, gw, _p_j, p_t = scene(img=8)
    _cam_j, cam_t = cameras([0.2, 0.1, 1.4], img=8)
    view = exact.exact_view(cam_t, p_t, GMIN, GMAX, device="cpu")
    out = torch.zeros((view.n_rays, 4))
    g = torch.from_numpy(gw)
    args = [torch.from_numpy(vol), torch.from_numpy(tf), view, out, g]
    bad = [
        (0, torch.from_numpy(vol).to(torch.uint8), TypeError),  # f32 only
        (0, torch.from_numpy(vol)[None, None], ValueError),  # a set is (B, Z, Y, X)
        (0, torch.from_numpy(np.stack([vol, vol])), ValueError),  # two bricks, one box row
        (1, torch.from_numpy(tf[:, :3].copy()), ValueError),  # the TF is (T, 4)
        (1, torch.zeros((0, 4)), ValueError),  # T >= 1
        (4, g[:-1].contiguous(), ValueError),  # g is (R, 4)
        (4, g.double(), TypeError),
        (2, dataclasses.replace(view, brick_boxes=view.brick_boxes.repeat(2, 1)), ValueError),
    ]
    for i, value, err in bad:
        wrong = list(args)
        wrong[i] = value
        with pytest.raises(err):
            exact.march_exact_backward(*wrong)
    meta_view = dataclasses.replace(
        view, ray_pack=view.ray_pack.to("meta"), brick_boxes=view.brick_boxes.to("meta")
    )
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else meta_view for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        exact.march_exact_backward(*meta)
    meta[1] = torch.empty((exact.EXACT_TF_MAX + 1, 4), device="meta")  # any T: no limit
    with pytest.raises(ValueError, match="no kernel"):
        exact.march_exact_backward(*meta)
    with pytest.raises(TypeError, match="float32"):
        exact.render_exact_diff(torch.from_numpy(vol).double(), torch.from_numpy(tf), view)


# ------------------------------------------------------- the exit rule in K4
def exit_split(out_port, out_jax, tol=2e-5):
    """(R,) bool: the rays whose two forwards differ by more than ``tol``
    in some channel, i.e. whose exit sample differs (the port folds
    chunks in closed form, the JAX oracle composites serially, so alpha
    crosses the threshold a sample apart on a few rays)."""
    return (np.abs(out_port - out_jax) > tol).any(axis=1)


def exit_grads(vol, tf, gw, cam_j, cam_t, p_j, p_t, g_mask):
    """(port (d_volume, d_tf), JAX oracle's) of sum(out · gw · g_mask) with
    the early exit on: the port through ``render_marcher_diff`` (plain K3
    forward, plain K4 backward with the exit rule)."""
    g = gw * g_mask[:, None]
    v = torch.from_numpy(vol).requires_grad_()
    t = torch.from_numpy(tf).requires_grad_()
    view = exact.exact_view(cam_t, p_t, GMIN, GMAX, device="cpu")
    out = exact.render_marcher_diff(v, t, view)
    (out * torch.from_numpy(g)).sum().backward()
    return (v.grad.numpy(), t.grad.numpy()), oracle_grads(vol, tf, g, cam_j, p_j)


@pytest.mark.parametrize("case", ["default", "dense"])
def test_exit_rule_matches_jax_oracle(case):
    """The plain K4 with the early exit on, against ``jax.grad`` of the
    JAX oracle (``reference.render_reference``): at the default 0.999 on
    the random scene, and at 0.5 on a dense field where most rays exit.
    On the rays whose exit sample agrees, both gradients within 1e-4 of
    the largest entry; the rays whose exit moved by a sample are under 1%
    of the rays and their gradients within 1 − early_exit of the largest
    entry of the whole gradient."""
    early_exit = {"default": 0.999, "dense": 0.5}[case]
    vol, tf, gw, p_j, p_t = scene()
    if case == "dense":
        vol = (0.6 + 0.4 * vol).astype(np.float32)
    p_j = dataclasses.replace(p_j, early_exit=early_exit)
    p_t = dataclasses.replace(p_t, early_exit=early_exit)
    cam_j, cam_t = cameras([0.25, 0.12, 1.4], img=16)
    view = exact.exact_view(cam_t, p_t, GMIN, GMAX, device="cpu")
    with torch.no_grad():
        out_t = exact.render_marcher_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)
    out_j = np.asarray(ref_j.render_reference(
        ref_j.single_brick_set(jnp.asarray(vol)), jnp.asarray(tf), cam_j, p_j, GMIN, GMAX
    )).reshape(-1, 4)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=1e-3)
    exited = out_j[:, 3] > early_exit
    assert exited.mean() > (0.5 if case == "dense" else 0.05), exited.mean()
    moved = exit_split(out_t.numpy(), out_j)
    assert moved.sum() < 0.01 * moved.size, moved.sum()
    full = exit_grads(vol, tf, gw, cam_j, cam_t, p_j, p_t, np.ones(moved.size, np.float32))
    agree = exit_grads(vol, tf, gw, cam_j, cam_t, p_j, p_t, (~moved).astype(np.float32))
    off = exit_grads(vol, tf, gw, cam_j, cam_t, p_j, p_t, moved.astype(np.float32))
    for i in (0, 1):
        got, want = agree[0][i], agree[1][i]
        scale = np.abs(want).max()
        assert scale > 0.1
        assert np.abs(got - want).max() / scale <= 1e-4
        assert np.abs(off[0][i] - off[1][i]).max() <= (1.0 - early_exit) * np.abs(full[1][i]).max()
    # The exit cut samples off: the gradient differs from the exit-off one.
    p_off = dataclasses.replace(p_t, early_exit=1.1)
    no_exit = exit_grads(vol, tf, gw, cam_j, cam_t, dataclasses.replace(p_j, early_exit=1.1),
                         p_off, np.ones(moved.size, np.float32))
    assert np.abs(no_exit[0][0] - full[0][0]).max() > 1e-3


def test_exit_rule_matches_plain_march_samples():
    """The plain K4 stops where the plain K3 stops: on a field where every
    ray exits within a few samples, the voxels behind every exit get no
    gradient and those in front do."""
    vol, tf, gw, _p_j, p_t = scene()
    vol[:] = 0.9
    vol[:2] = 0.3  # the far z slices, seen only after the rays' exit
    p_t = dataclasses.replace(p_t, early_exit=0.5)
    _cam_j, cam_t = cameras([0.0, 0.0, 1.4], img=16)
    view = exact.exact_view(cam_t, p_t, GMIN, GMAX, device="cpu")
    with torch.no_grad():
        out = exact.render_marcher_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)
    samples = torch.zeros(view.n_rays, dtype=torch.int32)
    slot = torch.zeros(1, dtype=torch.int32)
    exact.march_exact_reference(
        torch.from_numpy(vol)[None], slot, view.brick_boxes, torch.from_numpy(tf),
        view.ray_pack, torch.zeros((view.n_rays, 4)), view.eye, p_t,
        max_steps=view.max_steps, samples=samples)
    hit = samples > 0
    assert bool((out[hit, 3] > 0.5).all()) and int(samples[hit].max()) < 16
    d_vol, d_tf = exact.march_exact_backward(
        torch.from_numpy(vol), torch.from_numpy(tf), view, out, torch.from_numpy(gw))
    assert float(d_vol[8:].abs().max()) > 0
    assert float(d_vol[:4].abs().max()) == 0.0  # behind every exit
    assert float(d_tf.abs().max()) > 0


def test_render_exact_diff_still_refuses_the_exit():
    """``render_exact_diff`` keeps the exact trainer's contract; the
    marcher's Function takes the exit, and on a multi-brick set (the 16³
    volume in 2³ bricks with two ghost voxels, through the set's view) its
    forward and gradients are the plain set spec's: the plain K3 over
    slots ``arange(8)`` and ``march_exact_backward_reference`` over the
    set, bit for bit."""
    from libre_tpu_torch.testing import split_into_bricks

    vol, tf, gw, _p_j, p_t = scene()
    _cam_j, cam_t = cameras([0.2, 0.1, 1.4], img=16)
    params = dataclasses.replace(p_t, early_exit=0.999)
    view = exact.exact_view(cam_t, params, GMIN, GMAX, device="cpu")
    with pytest.raises(ValueError, match="early_exit"):
        exact.render_exact_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)
    out = exact.render_marcher_diff(torch.from_numpy(vol), torch.from_numpy(tf), view)
    assert out.shape == (view.n_rays, 4)
    bricks = split_into_bricks(vol, 2, overlap=2, device="cpu")
    set_view = exact.exact_view(cam_t, params, GMIN, GMAX, bricks=bricks, device="cpu")
    assert set_view.brick_boxes.shape == (8, 16)
    data = bricks.data.clone().requires_grad_()
    tf_t = torch.from_numpy(tf).requires_grad_()
    out = exact.render_marcher_diff(data, tf_t, set_view)
    g = torch.from_numpy(gw)
    (out * g).sum().backward()
    want = exact.march_exact_reference(
        bricks.data, torch.arange(8, dtype=torch.int32), set_view.brick_boxes, tf_t.detach(),
        set_view.ray_pack, torch.zeros((set_view.n_rays, 4)), set_view.eye, params,
        max_steps=set_view.max_steps)
    assert torch.equal(out.detach(), want)
    assert float(want[:, 3].max()) > 0.999
    d_vol, d_tf = exact.march_exact_backward_reference(bricks.data, tf_t.detach(), set_view,
                                                       want, g)
    assert torch.equal(data.grad, d_vol) and torch.equal(tf_t.grad, d_tf)
    assert all(float(d_vol[b].abs().max()) > 0 for b in range(8))
