"""The port's store assembly (libre_tpu_torch.ops.shearwarp_bricked.
assemble_store / store_content) against the JAX package's.

Both sides assemble from the same atlas contents (the JAX flat atlas,
carried across with ``interop.atlas_from_jax``) and the same plan.  A
full finest level is exact; a mixed-LOD set goes through f32 upsample
products summed in another order, so atol 1e-5 (the JAX package's own
bound against its numpy blend).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libre_tpu.core.nodeid import NodeId
from libre_tpu.data.datasource import DataSource, load_plugins
from libre_tpu.ops import shearwarp_bricked as swb_j
from libre_tpu.ops.atlas import BrickAtlas
from libre_tpu_torch import interop
from libre_tpu_torch.ops import shearwarp_bricked as swb_t
from libre_tpu_torch.ops.atlas import BrickAtlas as BrickAtlasT
from tests.test_bricked import fine_nodes, make_scene, upload_nodes

torch.set_num_threads(1)
load_plugins()


def mixed_set(ds):
    """Finest bricks, with the (0,0,0) octant's replaced by its parent."""
    nodes, fine = fine_nodes(ds)
    parent = NodeId.from_coords(fine - 1, (0, 0, 0))
    return [n for n in nodes if not all(p < 2 for p in n.position)] + [parent]


def mem_scene():
    ds = DataSource("mem://#64,64,64,16?pattern=gradient")
    nodes, _ = fine_nodes(ds)
    info = ds.volume_info
    padded = info.maximum_block_size
    atlas = BrickAtlas(len(nodes) + 1, (padded[2], padded[1], padded[0]), jnp.uint8)
    slots = {}
    for n in nodes:
        slots[n.id] = atlas.acquire()
        atlas.upload(slots[n.id], ds.get_data(n))
    return ds, nodes, atlas, lambda n: slots[n.id], info.data_type.default_range


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_assembly")
    _vol, ds32 = make_scene(tmp)
    _vol, ds64 = make_scene(tmp, n=64, block=16)
    return {"32": ds32, "64": ds64}


CASES = {
    # name: (scene, node filter, axis, (a_lo, a_hi_incl) or None, atol)
    "fine_exact": ("32", None, 2, None, 0.0),
    "fine_axis_x": ("32", None, 0, None, 0.0),
    "partial": ("32", lambda n: n.position != (0, 0, 0), 2, None, 0.0),
    "mixed_lod": ("64", "mixed", 2, None, 1e-5),
    "mixed_lod_axis_y": ("64", "mixed", 1, None, 1e-5),
    "mixed_lod_slab": ("64", "mixed", 2, (10, 37), 1e-5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assembly_matches_jax(scenes, case):
    key, keep, axis, rng, atol = CASES[case]
    ds = scenes[key]
    if keep == "mixed":
        nodes = mixed_set(ds)
    else:
        nodes, _ = fine_nodes(ds)
        nodes = [n for n in nodes if keep is None or keep(n)]
    atlas, slot_of = upload_nodes(ds, nodes)
    plan_j = swb_j.build_assembly_plan(ds, nodes, axis, slot_of, (0.0, 1.0))
    plan_t = swb_t.build_assembly_plan(ds, nodes, axis, slot_of, (0.0, 1.0))
    assert _same_plan(plan_t, plan_j)

    a_lo, a_hi = rng if rng else (0, None)
    want = np.asarray(swb_j.assemble_store(atlas.data, plan_j, a_lo, a_hi))
    atlas_t = torch.from_numpy(
        interop.atlas_from_jax(np.asarray(atlas.data), atlas.brick_shape)
    )
    got = swb_t.assemble_store(atlas_t, plan_t, a_lo, a_hi)
    na, nc, nb = plan_t.fine_dims
    slices = got.shape[0]
    assert got.shape == (slices, nc, nb) and got.dtype == torch.float32
    want = want[:slices, :nc, :nb]
    if atol == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=atol)
    if rng is None:
        content_j = np.asarray(swb_j.store_content(jnp.asarray(want), na))
        np.testing.assert_array_equal(swb_t.store_content(got).numpy(), content_j)


def _same_plan(plan_t, plan_j):
    """Field-wise plan equality (numpy tables compare by value)."""
    conv = interop.assembly_plan_from_jax(plan_j)
    for lt, lj in zip(plan_t.levels, conv.levels):
        for f in ("slots", "resident", "own"):
            np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f))
        assert (lt.level, lt.factor, lt.dims) == (lj.level, lj.factor, lj.dims)
    return (
        plan_t.axis, plan_t.render_level, plan_t.fine_dims, plan_t.block,
        plan_t.padded_zyx, plan_t.overlap, plan_t.lo, plan_t.hi,
    ) == (
        conv.axis, conv.render_level, conv.fine_dims, conv.block,
        conv.padded_zyx, conv.overlap, conv.lo, conv.hi,
    )


def test_native_uint8_assembly_matches_jax():
    """uint8 bricks stay uint8 in the port's atlas and are cast on
    gather.  atol 1e-7: XLA turns the division by the (0, 255) data
    range into a multiplication by its reciprocal, one ulp off torch's
    division."""
    ds, nodes, atlas, slot_of, rng = mem_scene()
    plan_j = swb_j.build_assembly_plan(ds, nodes, 2, slot_of, rng)
    want = np.asarray(swb_j.assemble_store(atlas.data, plan_j))
    atlas_t = BrickAtlasT(atlas.n_slots, atlas.brick_shape, np.uint8, device="cpu")
    assert atlas_t.data.dtype == torch.uint8
    flat = interop.atlas_from_jax(np.asarray(atlas.data), atlas.brick_shape)
    slots = sorted({slot_of(n) for n in nodes})
    atlas_t.upload_many(slots, flat[slots])
    np.testing.assert_array_equal(atlas_t.gather(slots).numpy(), flat[slots])
    got = swb_t.assemble_store(atlas_t.data, interop.assembly_plan_from_jax(plan_j))
    na, nc, nb = plan_j.fine_dims
    np.testing.assert_allclose(got.numpy(), want[:na, :nc, :nb], rtol=0, atol=1e-7)


def test_atlas_free_list_and_capacity():
    from libre_tpu_torch.ops.atlas import AtlasFullError, atlas_capacity

    assert atlas_capacity(10 * 24**3, (24, 24, 24), np.uint8) == 10
    assert atlas_capacity(10 * 24**3 * 4, (24, 24, 24), torch.float32) == 10
    atlas = BrickAtlasT(2, (2, 3, 4), np.float32, device="cpu")
    s0, s1 = atlas.acquire(), atlas.acquire()
    with pytest.raises(AtlasFullError):
        atlas.acquire()
    brick = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    atlas.upload(s1, brick)
    np.testing.assert_array_equal(atlas.gather([s1])[0].numpy(), brick)
    with pytest.raises(ValueError):
        atlas.upload(s0, brick.reshape(4, 3, 2))
    atlas.release(s0)
    assert atlas.free_slots == 1
