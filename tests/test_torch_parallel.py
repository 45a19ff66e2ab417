"""The port's mesh, compositing, sharded exact march, sharded dense
pipelines and ``interop``'s sharded-state helpers against the JAX
package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
under ``shard_map`` (Pallas in interpret mode); the port runs the same
decomposition over meshes of repeated ``cpu`` devices, each kernel by its
plain version.  Tolerances: the compositing forms 1e-6; the sharded
exact march 1e-5 against the JAX sharded march (both the same
decomposition; 2e-3 against a one-device march, the early exit being
local to a segment); the sharded dense pipeline 2e-5 and its TF gradient
1e-5 of the largest entry against JAX's; the sharded K5 sweep 2e-5
against JAX's; ``VolumeScene.render_sharded`` 1e-5 against JAX's.
A fake stream recorder checks that every move of ``compositing`` runs
with its source's and its destination's frame streams current.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from libre_tpu.ops import rays as ray_ops_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import RenderParams as ParamsJ
from libre_tpu.ops.reference import max_steps_for_bricks
from libre_tpu.parallel import compositing as comp_j
from libre_tpu.parallel import make_mesh as make_mesh_j
from libre_tpu.parallel import render as render_j
from libre_tpu_torch import interop
from libre_tpu_torch.ops.reference import RenderParams as ParamsT
from libre_tpu_torch.parallel import compositing as comp_t
from libre_tpu_torch.parallel import mesh as mesh_t
from libre_tpu_torch.parallel import render as render_t
from tests.test_reference_marcher import CAMERA, GLOBAL_MAX, GLOBAL_MIN, _split_into_bricks, make_volume

torch.set_num_threads(1)
CPU = torch.device("cpu")


def cpu_mesh(n_brick, n_ray):
    return mesh_t.make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[CPU] * (n_brick * n_ray))


# ------------------------------------------------------------------ mesh
def test_make_mesh_and_parse():
    m = cpu_mesh(2, 3)
    assert m.shape == {"ray": 3, "brick": 2} and m.size == 6 and m.lead == CPU
    assert [(vd, kd) for vd, kd, _ in m.shards()] == [(v, k) for v in range(3) for k in range(2)]
    assert m.distinct_devices() == (CPU,)
    assert mesh_t.make_mesh(n_brick=2, devices=[CPU] * 4).shape == {"ray": 2, "brick": 2}
    assert mesh_t.parse_mesh("2x4", [CPU] * 8).shape == {"ray": 2, "brick": 4}
    assert mesh_t.parse_mesh("auto", [CPU] * 4).shape == {"ray": 2, "brick": 2}
    assert mesh_t.parse_mesh("auto", [CPU]).shape == {"ray": 1, "brick": 1}
    with pytest.raises(ValueError):
        mesh_t.make_mesh(n_brick=3, devices=[CPU] * 4)
    with pytest.raises(ValueError):
        mesh_t.make_mesh(n_brick=2, n_ray=3, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="RxB"):
        mesh_t.parse_mesh("two", [CPU])
    with pytest.raises(TypeError):
        mesh_t.require_mesh("f", object())


def test_interop_mesh_and_slabs():
    mj = make_mesh_j(n_brick=4, n_ray=2)
    mt = interop.mesh_from_jax(mj, device="cpu")
    assert mt.shape == {"ray": 2, "brick": 4} and mt.distinct_devices() == (CPU,)
    rng = np.random.default_rng(0)
    store = rng.random((16, 6, 5)).astype(np.float32)
    padded = np.full((16, 128, 128), -1024.0, np.float32)
    padded[:, :6, :5] = store
    slabs, a_base = interop.store_slabs_from_jax(
        padded.reshape(4, 4, 128, 128), np.arange(4) * 4, (16, 6, 5)
    )
    assert a_base.dtype == np.int32 and list(a_base) == [0, 4, 8, 12]
    np.testing.assert_array_equal(np.concatenate(slabs), store)
    # A slab past the store's end keeps only the store's slices.
    past = np.concatenate([padded[12:16], np.full((2, 128, 128), -1024.0, np.float32)])
    slabs, _ = interop.store_slabs_from_jax(past[None], [12], (16, 6, 5))
    np.testing.assert_array_equal(slabs[0], store[12:16])
    with pytest.raises(ValueError):
        interop.store_slabs_from_jax(padded.reshape(4, 4, 128, 128), [0, 4], (16, 6, 5))


# ----------------------------------------------------------- compositing
def segments(seed, d=8, r=32):
    rng = np.random.default_rng(seed)
    return (rng.random((d, r, 3), dtype=np.float32),
            (rng.random((d, r), dtype=np.float32) * 0.6).astype(np.float32))


def test_over_and_fold_match_jax():
    rgb, a = segments(1, d=5)
    want = comp_j.fold_over(jnp.asarray(rgb), jnp.asarray(a))
    got = comp_t.fold_over(torch.from_numpy(rgb), torch.from_numpy(a))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    front = (torch.from_numpy(rgb[0]), torch.from_numpy(a[0]))
    back = (torch.from_numpy(rgb[1]), torch.from_numpy(a[1]))
    wj = comp_j.over((jnp.asarray(rgb[0]), jnp.asarray(a[0])), (jnp.asarray(rgb[1]), jnp.asarray(a[1])))
    for g, w in zip(comp_t.over(front, back), wj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("form", ["along_axis", "gather", "direct_send"])
def test_composite_forms_match_jax(form):
    """Each form over 8 shards' segments against the JAX form under
    shard_map, and differentiable: its gradients equal fold_over's."""
    rgb, a = segments(3)
    mesh = make_mesh_j(n_brick=8, n_ray=1)
    fn_j = {"along_axis": comp_j.composite_along_axis,
            "gather": comp_j.composite_along_axis_gather,
            "direct_send": comp_j.composite_direct_send}[form]

    def body(rgb_l, a_l):
        r, al = fn_j(rgb_l[0], a_l[0], "brick")
        out = jnp.concatenate([r, al[..., None]], axis=-1)
        return out if form == "direct_send" else out[None]

    want = np.asarray(shard_map(
        body, mesh=mesh, in_specs=(P("brick"), P("brick")), out_specs=P("brick"),
    )(jnp.asarray(rgb), jnp.asarray(a)))
    if form != "direct_send":
        want = want[0]  # replicated: every shard holds the whole result

    def port(rgb_t, a_t):
        segs = [(rgb_t[i], a_t[i]) for i in range(8)]
        if form == "direct_send":
            return torch.cat([comp_t.join_rgba(t) for t in comp_t.composite_direct_send(segs)])
        fn = comp_t.composite_along_axis if form == "along_axis" else comp_t.composite_along_axis_gather
        return comp_t.join_rgba(fn(segs))

    rgb_t = torch.from_numpy(rgb).requires_grad_()
    a_t = torch.from_numpy(a).requires_grad_()
    got = port(rgb_t, a_t)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    (got ** 2).sum().backward()
    rgb_r = torch.from_numpy(rgb).requires_grad_()
    a_r = torch.from_numpy(a).requires_grad_()
    (comp_t.join_rgba(comp_t.fold_over(rgb_r, a_r)) ** 2).sum().backward()
    np.testing.assert_allclose(rgb_t.grad.numpy(), rgb_r.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(a_t.grad.numpy(), a_r.grad.numpy(), atol=1e-5)
    if form == "direct_send":
        with pytest.raises(ValueError):
            comp_t.composite_direct_send([(rgb_t[i, :30], a_t[i, :30]) for i in range(8)])


def test_moves_run_on_the_frame_streams(monkeypatch):
    """Every copy the compositing forms make between devices runs with the
    destination's (and the source's) frame stream current: a fake stream
    context records which streams are current when each copy is made."""
    current, copies = [], []

    @contextlib.contextmanager
    def fake_stream(stream):
        current.append(stream)
        try:
            yield
        finally:
            current.pop()

    def fake_copy(x, device):
        copies.append((device, list(current)))
        return x  # the values stay on the CPU

    monkeypatch.setattr(comp_t, "_stream_context", fake_stream)
    monkeypatch.setattr(comp_t, "_copy", fake_copy)
    # Four "devices" the CPU tensors are not on, each with a frame stream.
    devs = [torch.device("cuda", i) for i in range(4)]
    streams = {d: f"stream {d.index}" for d in devs}
    rgb, a = segments(4, d=4, r=8)
    segs = [(torch.from_numpy(rgb[i]), torch.from_numpy(a[i])) for i in range(4)]
    comp_t.composite_direct_send(segs, devs, streams)
    comp_t.composite_along_axis(segs, devs[1], streams)
    comp_t.composite_along_axis_gather(segs, devs[2], streams)
    assert len(copies) == 4 * 4 * 2 + 4 * 2 + 4 * 2
    for dev, cur in copies:
        assert cur == [streams[dev]], (dev, cur)
    # A tensor already on the destination is not copied; none without a
    # destination stream runs under one.
    x = torch.zeros(2)
    assert comp_t.move(x, "cpu", streams) is x
    comp_t.move(x, devs[0], None)
    assert copies[-1] == (devs[0], [])


# ------------------------------------------------------- the exact march
N_IMG = 16
PARAMS = dict(n_samples_per_ray=32, data_source_range=(0.0, 1.0), filter_mode="trilinear")


@pytest.fixture(scope="module")
def march_scene():
    cam = CAMERA._replace(viewport=(0, 0, N_IMG, N_IMG))
    volume = make_volume(16, seed=3)
    tf = tf_j.default_color_map(256)
    bricks_j = _split_into_bricks(volume, 2, overlap=2)
    eye, dirs, cos_z, _ = ray_ops_j.make_rays(cam.inv_proj, cam.inv_mv, cam.viewport)
    dirs = dirs.reshape(-1, 3)
    tnp = ray_ops_j.near_plane_t(cos_z.reshape(-1), cam.near)
    return bricks_j, tf, eye, dirs, tnp


@pytest.mark.parametrize("n_brick,n_ray,n_keep", [(2, 2, 8), (4, 1, 7)])
def test_render_rays_sharded_matches_jax(march_scene, n_brick, n_ray, n_keep):
    """The port's sharded march (K3's plain version per shard) against the
    JAX package's sharded XLA march at the same mesh shape; 7 of 8 bricks
    over 4 brick shards pads one."""
    bricks_j, tf, eye, dirs, tnp = march_scene
    bricks_j = jax.tree.map(lambda x: x[:n_keep], bricks_j)
    params_j = ParamsJ(**PARAMS)
    max_steps = max_steps_for_bricks(bricks_j.world_min, bricks_j.world_max, params_j.step_size)
    sharded_j, slots_j = render_j.shard_bricks_front_to_back(bricks_j, np.asarray(eye), n_brick)
    want = np.asarray(render_j.render_rays_sharded(
        make_mesh_j(n_brick=n_brick, n_ray=n_ray), sharded_j, jnp.asarray(tf), eye, dirs, tnp,
        params_j, GLOBAL_MIN, GLOBAL_MAX, max_steps,
    ))
    sharded_t, slots_t = render_t.shard_bricks_front_to_back(
        interop.brick_set_from_jax(bricks_j, device="cpu"), np.asarray(eye), n_brick
    )
    np.testing.assert_array_equal(slots_t, slots_j)
    assert sharded_t.num_bricks % n_brick == 0
    got = render_t.render_rays_sharded(
        cpu_mesh(n_brick, n_ray), sharded_t, torch.from_numpy(np.array(tf)),
        torch.from_numpy(np.array(eye)), torch.from_numpy(np.array(dirs)),
        torch.from_numpy(np.array(tnp)), ParamsT(**PARAMS), GLOBAL_MIN, GLOBAL_MAX,
        max_steps, width=N_IMG,
    )
    assert got.shape == (N_IMG * N_IMG, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert float(got[:, 3].max()) > 0.1


def test_render_rays_sharded_gradient_rules(march_scene):
    """Under autograd, four bricks per shard on ``cpu_mesh(2, 1)`` (K4
    over each shard's chunk by its plain version, the TF gradient summed
    over the shards) against ``jax.grad`` of the JAX sharded march on a
    (2 brick × 1 ray) mesh: the image 1e-5, the density and TF gradients
    within 1e-4 of their largest entries; the forward equals the one
    without autograd; the 8 → 2 shards also run on ``cpu_mesh(8, 1)``."""
    bricks_j, tf, eye, dirs, tnp = march_scene
    params_j = ParamsJ(**dict(PARAMS, early_exit=1.1))
    params = ParamsT(**dict(PARAMS, early_exit=1.1))
    max_steps = max_steps_for_bricks(
        np.asarray(bricks_j.world_min), np.asarray(bricks_j.world_max), params.step_size
    )
    sharded_j, _ = render_j.shard_bricks_front_to_back(bricks_j, np.asarray(eye), 2)
    g = np.random.default_rng(3).random((N_IMG * N_IMG, 4), dtype=np.float32)
    mesh_j = make_mesh_j(n_brick=2, n_ray=1)

    def loss(data, tf_):
        out = render_j.render_rays_sharded(
            mesh_j, sharded_j._replace(data=data), tf_, eye, dirs, tnp, params_j,
            GLOBAL_MIN, GLOBAL_MAX, max_steps,
        )
        return jnp.sum(out * g), out

    # Under jit with the input shardings, as tests/test_parallel.py
    # differentiates it (the eager transpose of shard_map fails).
    grad_j = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        in_shardings=(NamedSharding(mesh_j, P("brick")), NamedSharding(mesh_j, P())),
    )
    (_, want), (want_d, want_tf) = grad_j(sharded_j.data, jnp.asarray(tf))
    bricks, _ = render_t.shard_bricks_front_to_back(interop.brick_set_from_jax(bricks_j, device="cpu"), np.asarray(eye), 2)
    data = bricks.data.clone().requires_grad_()
    tf_t = torch.from_numpy(np.array(tf)).requires_grad_()
    args = (torch.from_numpy(np.array(eye)), torch.from_numpy(np.array(dirs)),
            torch.from_numpy(np.array(tnp)), params, GLOBAL_MIN, GLOBAL_MAX, max_steps)
    out = render_t.render_rays_sharded(
        cpu_mesh(2, 1), bricks._replace(data=data), tf_t, *args, width=N_IMG)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-5)
    for got, ref in ((data.grad, want_d), (tf_t.grad, want_tf)):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0.1
        assert np.abs(got.numpy() - ref).max() / scale <= 1e-4
    with torch.no_grad():
        plain = render_t.render_rays_sharded(cpu_mesh(2, 1), bricks, tf_t, *args, width=N_IMG)
        eight = render_t.render_rays_sharded(cpu_mesh(8, 1), bricks, tf_t, *args, width=N_IMG)
    np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
    np.testing.assert_allclose(eight.numpy(), plain.numpy(), atol=1e-5)


def test_volume_scene_render_sharded_matches_jax():
    from libre_tpu.models import VolumeScene as SceneJ
    from libre_tpu_torch.models import VolumeScene as SceneT
    from libre_tpu_torch.ops.reference import Camera as CameraT

    cam = CAMERA._replace(viewport=(0, 0, N_IMG, N_IMG))
    vol = make_volume(16, seed=2)
    tf = tf_j.default_color_map(256)
    sj = SceneJ.from_volume(vol, tf=tf, params=ParamsJ(**PARAMS))
    st = SceneT.from_volume(vol, tf=tf, params=ParamsT(**PARAMS), device="cpu")
    want = np.asarray(sj.render_sharded(make_mesh_j(n_brick=2, n_ray=4), cam))
    got = st.render_sharded(cpu_mesh(2, 4), CameraT(*cam))
    assert got.shape == (N_IMG, N_IMG, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    one = st.render(CameraT(*cam))
    np.testing.assert_allclose(got.numpy(), one.detach().numpy(), atol=1e-5)


# ------------------------------------------------------- dense pipelines
def dense_scene():
    from libre_tpu.ops import shearwarp as sw_j
    from tests.test_shearwarp import make_camera

    volume = make_volume(16, seed=3)
    cam = make_camera([0.2, 0.1, 1.4])
    return volume, tf_j.default_color_map(256), sw_j.make_plan(cam)


@pytest.mark.parametrize("n_brick,n_ray", [(2, 2), (4, 1)])
def test_shearwarp_sharded_matches_jax(n_brick, n_ray):
    """The dense plain pipeline sharded (pre-classified, as the JAX
    package always is) against JAX's, and its TF gradient against
    ``jax.grad`` of JAX's."""
    from libre_tpu.ops import shearwarp as sw_j
    from libre_tpu.parallel.shearwarp_sharded import render_slope_grid_sharded as sharded_j
    from libre_tpu_torch.ops import shearwarp as sw_t
    from libre_tpu_torch.parallel.shearwarp_sharded import render_slope_grid_sharded as sharded_t

    volume, tf, plan = dense_scene()
    params = dict(n_samples_per_ray=16, data_source_range=(0.0, 1.0), early_exit=1.1)
    gmin, gmax = GLOBAL_MIN, GLOBAL_MAX
    mesh_j = make_mesh_j(n_brick=n_brick, n_ray=n_ray)

    def loss_j(tf_arr):
        img = sharded_j(
            mesh_j, jnp.asarray(volume), tf_arr, plan.eye, plan.axis, plan.sign, plan.bounds,
            gmin, gmax, ParamsJ(**params),
            sw_j.ShearWarpParams(n_planes=16, inter_size=(8, 12), classification="pre"),
        )
        return jnp.sum(img ** 2), img

    (_, want), g_want = jax.value_and_grad(loss_j, has_aux=True)(jnp.asarray(tf))
    tf_t = torch.from_numpy(np.array(tf)).requires_grad_()
    got = sharded_t(
        cpu_mesh(n_brick, n_ray), torch.from_numpy(volume), tf_t, plan.eye, plan.axis,
        plan.sign, plan.bounds, gmin, gmax, ParamsT(**params),
        sw_t.ShearWarpParams(n_planes=16, inter_size=(8, 12), classification="pre"),
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    (got ** 2).sum().backward()
    scale = float(np.abs(np.asarray(g_want)).max())
    np.testing.assert_allclose(tf_t.grad.numpy() / scale, np.asarray(g_want) / scale, atol=1e-5)


def test_shearwarp_sharded_post_matches_one_device():
    """With "post" classification (which the JAX sharded pipeline does not
    follow) the port's sharded image equals its own one-device image."""
    from libre_tpu_torch.ops import shearwarp as sw_t
    from libre_tpu_torch.parallel.shearwarp_sharded import render_slope_grid_sharded

    volume, tf, plan = dense_scene()
    params = ParamsT(n_samples_per_ray=16, data_source_range=(0.0, 1.0), early_exit=1.1)
    swp = sw_t.ShearWarpParams(n_planes=16, inter_size=(8, 12), classification="post")
    args = (torch.from_numpy(np.array(tf)), plan.eye, plan.axis, plan.sign, plan.bounds,
            GLOBAL_MIN, GLOBAL_MAX, params, swp)
    one, _, _ = sw_t.render_slope_grid(torch.from_numpy(volume), *args)
    got = render_slope_grid_sharded(cpu_mesh(2, 2), torch.from_numpy(volume), *args)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-5)
    with pytest.raises(ValueError):
        render_slope_grid_sharded(cpu_mesh(1, 3), torch.from_numpy(volume), *args)


@pytest.mark.parametrize("n_brick,n_ray", [(2, 2), (4, 1)])
def test_classified_sweep_sharded_matches_jax(n_brick, n_ray):
    """K5 per shard (``shearwarp_dense.render_slope_grid_sharded``, its
    plain version here) against the JAX package's Pallas-sharded sweep in
    interpret mode."""
    from libre_tpu.ops import shearwarp as sw_j
    from libre_tpu.ops import shearwarp_pallas as swp_j
    from libre_tpu_torch.ops import shearwarp as sw_t
    from libre_tpu_torch.ops import shearwarp_dense as swd

    volume, tf, plan = dense_scene()
    params = dict(n_samples_per_ray=32, data_source_range=(0.0, 1.0))
    chans_j = swp_j.classify_planes(jnp.asarray(volume), jnp.asarray(tf), plan.axis, (0.0, 1.0))
    nc, nb = (16, 16)
    pa_j = swp_j.slope_grid_plan_args(
        plan, GLOBAL_MIN, GLOBAL_MAX, ParamsJ(**params, filter_mode="trilinear"),
        sw_j.ShearWarpParams(n_planes=32, inter_size=(16, 12)),
    )
    want = np.asarray(swp_j.render_slope_grid_sharded(
        make_mesh_j(n_brick=n_brick, n_ray=n_ray), chans_j, nc, nb, pa_j, interpret=True,
    ))
    chans_t = torch.from_numpy(interop.classified_from_jax(np.asarray(chans_j), nc, nb))
    pa_t = swd.slope_grid_plan_args(
        plan, GLOBAL_MIN, GLOBAL_MAX, ParamsT(**params),
        sw_t.ShearWarpParams(n_planes=32, inter_size=(16, 12)),
    )
    got = swd.render_slope_grid_sharded(cpu_mesh(n_brick, n_ray), chans_t, nc, nb, pa_t)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    one = swd.render_classified_slope_grid(chans_t, nc, nb, pa_t)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=2e-3)
    assert float(got[..., 3].max()) > 0.1
