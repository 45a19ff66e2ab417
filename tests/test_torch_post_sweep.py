"""The port's sweep (libre_tpu_torch.ops.shearwarp_bricked.post_sweep and
its frame tables) against the JAX package's fused Pallas frame.

Both sides render the slope grid of the tests/test_bricked.py scene
(32³, block 16, 24×20 rays, 64 planes) from the same assembled store;
the JAX side runs its Pallas kernel in interpret mode, the port runs
``post_sweep_reference`` (a CPU tensor).  Tolerance 2e-5, the bound the
JAX package holds its own kernel to against the plane oracle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libre_tpu.core.frustum import look_at, perspective
from libre_tpu.ops import shearwarp as sw_j
from libre_tpu.ops import shearwarp_bricked as swb_j
from libre_tpu.ops import transfer_function as tf_j
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp as sw_t
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.testing import sweep_case
from tests.test_bricked import GMAX, GMIN, fine_nodes, make_scene, upload_nodes

torch.set_num_threads(1)

N_PLANES = 64
INTER = (24, 20)
CLIP = np.float32([[1.0, 0.0, 0.0, 0.1], [0.0, -1.0, 0.5, 0.2]])


def cameras(w=24, h=24):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at([0.1, 0.05, 1.4], [0, 0, 0], [0, 1, 0])
    inv_proj = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)
    inv_mv = np.linalg.inv(mv.astype(np.float64)).astype(np.float32)
    return (
        CameraJ(inv_proj=inv_proj, inv_mv=inv_mv, viewport=(0, 0, w, h), near=0.1),
        CameraT(inv_proj=inv_proj, inv_mv=inv_mv, viewport=(0, 0, w, h), near=0.1),
    )


def saturating_tf():
    tf = tf_j.default_color_map(256)
    tf[:, 3] = np.clip(8.0 * tf[:, 3], 0.0, 1.0)
    return tf


CASES = {
    # name: (keep(node) -> bool, clip planes, pass content flags, tf)
    "plain": (lambda n: True, None, False, tf_j.default_color_map(256)),
    "clip": (lambda n: True, CLIP, False, tf_j.default_color_map(256)),
    "partial": (
        lambda n: n.position != (0, 0, 0), None, False,
        tf_j.default_color_map(256),
    ),
    "content": (
        lambda n: n.position[2] == 1, None, True, tf_j.default_color_map(256),
    ),
    "saturating": (lambda n: True, None, False, saturating_tf()),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    _vol, ds = make_scene(tmp_path_factory.mktemp("torch_sweep"))
    return ds


@pytest.mark.parametrize("case", sorted(CASES))
def test_slope_grid_matches_jax(scene, case):
    keep, clip, with_content, tf = CASES[case]
    nodes, _ = fine_nodes(scene)
    kept = [n for n in nodes if keep(n)]
    atlas, slot_of = upload_nodes(scene, kept)
    plan_j = swb_j.build_assembly_plan(scene, kept, 2, slot_of, (0.0, 1.0))
    store_j = swb_j.assemble_store(atlas.data, plan_j)
    content_j = swb_j.store_content(store_j, plan_j.fine_dims[0])
    cam_j, cam_t = cameras()
    want = np.asarray(
        swb_j.render_store_frame(
            store_j, plan_j, jnp.asarray(tf), cam_j,
            params=ParamsJ(n_samples_per_ray=N_PLANES, data_source_range=(0.0, 1.0)),
            swp=sw_j.ShearWarpParams(
                n_planes=N_PLANES, inter_size=INTER, classification="post"
            ),
            world_min=GMIN, world_max=GMAX, clip_planes_world=clip,
            content=content_j if with_content else None,
            to_screen=False, interpret=True,
        )
    )

    plan_t = interop.assembly_plan_from_jax(plan_j)
    store_t = torch.from_numpy(
        interop.store_from_jax(np.asarray(store_j), plan_t.fine_dims)
    )
    got = swb_t.render_store_frame(
        store_t, plan_t, torch.from_numpy(tf), cam_t,
        params=ParamsT(n_samples_per_ray=N_PLANES, data_source_range=(0.0, 1.0)),
        swp=sw_t.ShearWarpParams(n_planes=N_PLANES, inter_size=INTER),
        world_min=GMIN, world_max=GMAX, clip_planes_world=clip,
        content=swb_t.store_content(store_t) if with_content else None,
        to_screen=False,
    ).numpy()
    assert got.shape == INTER + (4,)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert got[..., 3].max() > 0.1
    if case == "saturating":
        assert got[..., 3].max() > 0.999  # the early exit fired


def test_sweep_tables_match_plane_tables():
    """The device-side frame tables equal the host plane tables."""
    na, k = 32, 100
    for sign in (1.0, -1.0):
        fv = torch.tensor(
            [-0.5, 0.5, 1.4, -0.4, 0.04, 0.03, 0.1, 0.05, -0.3, sign, 32.0],
            dtype=torch.float32,
        )
        tables = swb_t.sweep_tables(fv, na=na, k_planes=k, v_size=5, u_size=7)
        a0, a1, wa, dl, _z, _dz = swb_t.plane_tables(
            na=na, k_planes=k, wa0=-0.5, wa1=0.5, eye_a=1.4, sign=sign
        )
        np.testing.assert_array_equal(tables.a0.numpy(), a0)
        np.testing.assert_array_equal(tables.a1.numpy(), a1)
        np.testing.assert_allclose(tables.wa.numpy(), wa, atol=1e-6)
        np.testing.assert_allclose(tables.dl.numpy(), dl, atol=1e-6)
        assert tables.corr.shape == (5, 7) and tables.act.sum() == k


def test_post_sweep_rejects_bad_operands():
    store = torch.zeros((4, 5, 6))
    fv = torch.tensor(
        [-0.5, 0.5, 1.4, -0.4, 0.04, 0.03, 0.1, 0.05, -0.3, -1.0, 32.0]
    )
    tables = swb_t.sweep_tables(fv, na=4, k_planes=8, v_size=3, u_size=3)
    tf = torch.zeros((256, 4))
    clip = torch.zeros((8, 4))
    kw = dict(n_clip=0, wb=(-0.5, 0.5), wc=(-0.5, 0.5), early_exit=0.999)
    with pytest.raises(TypeError):
        swb_t.post_sweep(store.double(), tf, tables, clip, **kw)
    with pytest.raises(ValueError):
        swb_t.post_sweep(store, tf[:128], tables, clip, **kw)
    with pytest.raises(ValueError):
        swb_t.post_sweep(store, tf, tables, clip, **dict(kw, n_clip=9))
    launches = swb_t.post_sweep.launches
    swb_t.post_sweep(store, tf, tables, clip, **kw)
    assert swb_t.post_sweep.launches == launches  # CPU: plain version


def test_sample_count():
    """``samples`` counts the planes each ray fetches and changes nothing
    else: at most the active planes, fewer once the early exit fires."""
    store, tf, tables, clip, kw = sweep_case((12, 10, 32, 16, 12, 14), 0, "cpu")
    counts = {}
    for name, table in (("saturating", tf), ("clear", tf * torch.tensor([1.0, 1, 1, 0]))):
        samples = torch.zeros((12, 10), dtype=torch.int64)
        got, t = swb_t.post_sweep_reference(
            store, table, tables, clip, samples=samples, **kw
        )
        want, t_want = swb_t.post_sweep_reference(store, table, tables, clip, **kw)
        assert torch.equal(got, want) and torch.equal(t, t_want)
        assert int(samples.max()) <= int(tables.act.sum())
        assert float(got[..., 3][samples == 0].abs().max()) == 0.0
        counts[name] = samples
    assert bool((counts["saturating"] <= counts["clear"]).all())
    assert int(counts["saturating"].sum()) < int(counts["clear"].sum())
    assert int(counts["clear"].min()) == 0 < int(counts["clear"].max())


def test_touched_voxels_are_all_the_sweep_reads():
    """``touched`` marks every voxel the sweep reads: overwriting the
    others leaves the result bit-equal.  The early exit leaves a part of
    the sampled slices unread."""
    store, tf, tables, clip, kw = sweep_case((12, 10, 32, 16, 12, 14), 0, "cpu")
    touched = torch.zeros(store.shape, dtype=torch.bool)
    planes = torch.zeros(tables.a0.shape, dtype=torch.bool)
    want, t_want = swb_t.post_sweep_reference(
        store, tf, tables, clip, planes=planes, touched=touched, **kw
    )
    noise = torch.from_numpy(np.random.default_rng(5).random(store.shape, dtype=np.float32))
    got, t = swb_t.post_sweep_reference(
        torch.where(touched, store, noise), tf, tables, clip, **kw
    )
    assert torch.equal(got, want) and torch.equal(t, t_want)
    slices = torch.unique(torch.cat([tables.a0[planes], tables.a1[planes]]))
    assert 0 < int(touched.sum()) < slices.numel() * store.shape[1] * store.shape[2]
    assert not bool(touched[~torch.isin(torch.arange(store.shape[0]), slices)].any())
