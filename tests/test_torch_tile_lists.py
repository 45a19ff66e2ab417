"""The per-tile work lists of K1 (``csrc/post_sweep.cu``), K5
(``csrc/pre_sweep.cu``) and K3 (``csrc/exact_march.cu``), through their
plain versions ``shearwarp_bricked.tile_planes_reference`` and
``raycast.tile_bricks_reference``.

Over seeded views (the eye inside the volume, the eye inside a brick,
rays grazing a brick face, an oblique major axis, K ≠ Na, two clip
planes, a jittered sample, a carry in; for K5 the JAX package's dense
scene from four eyes and a classified stack with empty slices under the
sweep views), each list must be a superset of the work its tile does, and
restricting the plain sweep or march to the lists must change nothing:
the sweeps bit for bit, the march in its image, its per-ray sample counts
and its per-brick use flags.
"""

import dataclasses

import pytest
import torch

from libre_tpu_torch.ops import raycast
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.testing import (
    DENSE_EYES,
    DENSE_SWEEP_SHAPES,
    EXACT_BRICK_VIEWS,
    SWEEP_VIEWS,
    dense_case,
    dense_plain,
    exact_case,
    sweep_case,
)

torch.set_num_threads(1)

# Sweep cases: (view, (V, U, K, Na, Nc, Nb), carry in).  Ragged tiles in
# both u and v; K ≠ Na except in "same_k".
SWEEP_CASES = {
    "axis": ("axis", (40, 72, 80, 48, 40, 44), False),
    "inside": ("inside", (40, 72, 80, 48, 40, 44), False),
    "oblique": ("oblique", (40, 72, 80, 48, 40, 44), False),
    "carry": ("axis", (40, 72, 80, 48, 40, 44), True),
    "same_k": ("oblique", (20, 40, 48, 48, 24, 28), False),
}


# Dense (K5) cases: (dense_case case, eye or view, shape).  The "sweep"
# stack is ragged in u and v with K ≠ Na; "dense_same_k" has K = Na.
DENSE_CASES = {
    **{f"dense_scene_{eye}": ("scene", eye, None) for eye in DENSE_EYES},
    **{f"dense_{view}": ("sweep", view, DENSE_SWEEP_SHAPES[0]) for view in SWEEP_VIEWS},
    "dense_same_k": ("sweep", "oblique", DENSE_SWEEP_SHAPES[1]),
}


def _view(name):
    """The SWEEP_VIEWS view of a case, or None for the dense scene."""
    if name in SWEEP_CASES:
        return SWEEP_CASES[name][0]
    case, view, _shape = DENSE_CASES[name]
    return view if case == "sweep" else None


def _dense(name):
    case, arg, shape = DENSE_CASES[name]
    if case == "scene":
        return dense_case("scene", seed=3, device="cpu", eye=arg)
    return dense_case("sweep", seed=3, device="cpu", view=arg, shape=shape)


def _tables(name):
    """(tables, wb, wc) of a sweep or dense case."""
    if name in DENSE_CASES:
        c = _dense(name)
        return c.tables, c.kw["wb"], c.kw["wc"]
    _store, _tf, tables, _clip, kw = _sweep(name)
    return tables, kw["wb"], kw["wc"]


def _sweep(name):
    view, shape, carry = SWEEP_CASES[name]
    store, tf, tables, clip, kw = sweep_case(shape, seed=3, device="cpu", view=view)
    if carry:
        gen = torch.Generator().manual_seed(4)
        t_in = torch.rand(tables.t_in.shape, generator=gen)
        t_in[::5] = 1e-4  # past the early-exit threshold before the first plane
        rgb_in = torch.rand(tables.rgb_in.shape, generator=gen) * (1.0 - t_in)[..., None]
        tables = dataclasses.replace(tables, t_in=t_in, rgb_in=rgb_in)
    return store, tf, tables, clip, kw


@pytest.fixture(scope="module", params=sorted(SWEEP_CASES) + sorted(DENSE_CASES))
def sweep_lists(request):
    """K1's plain sweep (colour and alpha, transmittance) or K5's (colour
    and alpha) over all planes and over the lists."""
    if request.param in DENSE_CASES:
        c = _dense(request.param)
        want, fetches, lists = dense_plain(c)
        got = swd.pre_sweep_reference(c.chans, c.tables, only=lists, **c.kw)
        return request.param, c.tables, lists, fetches, (want,), (got,)
    store, tf, tables, clip, kw = _sweep(request.param)
    lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
    fetches = torch.zeros_like(lists)
    want = swb.post_sweep_reference(store, tf, tables, clip, fetches=fetches, **kw)
    got = swb.post_sweep_reference(store, tf, tables, clip, only=lists, **kw)
    return request.param, tables, lists, fetches, want, got


def test_plane_lists_cover_fetches(sweep_lists):
    """(a) Every (tile, plane) at which a ray of the tile fetches is on the
    tile's list."""
    _name, _tables, lists, fetches, _want, _got = sweep_lists
    assert int(fetches.sum()) > 0
    assert bool((fetches <= lists).all())


def test_sweep_restricted_to_plane_lists_is_bit_equal(sweep_lists):
    """(b) The plain sweep over each tile's listed planes only is bit-equal
    to the sweep over all K planes: colour, alpha and (K1) transmittance."""
    _name, _tables, _lists, _fetches, want, got = sweep_lists
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_plane_lists_leave_planes_out(sweep_lists):
    """The lists are a real cut: inactive planes are on no list, and with
    the eye outside the volume some tile lists fewer planes than the
    active ones (with the eye inside, every ray starts in the window); on
    the oblique views most tiles see the box at a few planes only."""
    name, tables, lists, _fetches, _want, _got = sweep_lists
    active = tables.act != 0
    assert not bool(lists[..., ~active].any())
    if _view(name) != "inside":
        assert int(lists.sum(dim=-1).min()) < int(active.sum())
    if _view(name) == "oblique":
        assert int(lists.sum()) < lists.numel() // 4


@pytest.mark.parametrize("name", sorted(SWEEP_CASES) + sorted(DENSE_CASES))
def test_plane_lists_bound_each_ray(name):
    """Every ray of a tile whose sample point lies in the window at an
    active plane finds that plane on its tile's list (the window test
    alone, before clip planes, SENTINEL and early exit)."""
    tables, wb, wc = _tables(name)
    lists = swb.tile_planes_reference(tables, wb, wc)
    v_size, u_size = tables.corr.shape
    u0, du, dv, eb, ec, v0 = tables.view[:6]
    ug = u0 + du * torch.arange(u_size, dtype=torch.float32)
    vg = v0 + dv * torch.arange(v_size, dtype=torch.float32)
    xb = eb + ug[:, None] * tables.dl  # (U, K)
    xc = ec + vg[:, None] * tables.dl  # (V, K)
    in_b = (xb >= wb[0]) & (xb < wb[1])
    in_c = (xc >= wc[0]) & (xc < wc[1])
    inside = in_c[:, None, :] & in_b[None, :, :] & (tables.act != 0)  # (V, U, K)
    rows, cols = swb.SWEEP_TILE
    per_ray = lists[torch.arange(v_size) // rows][:, torch.arange(u_size) // cols]
    assert bool((inside <= per_ray).all())


# March cases: the views of EXACT_BRICK_VIEWS (uint8 atlas, trilinear)
# and two filter/dtype variants of the off-axis view.
MARCH_CASES = {
    **{view: (view, "trilinear", torch.uint8) for view in EXACT_BRICK_VIEWS},
    "bricks_nearest_f32": ("bricks", "nearest", torch.float32),
    "in_brick_nearest": ("in_brick", "nearest", torch.uint8),
}


@pytest.fixture(scope="module", params=sorted(MARCH_CASES))
def march_lists(request):
    view, filter_mode, dtype = MARCH_CASES[request.param]
    c = exact_case(view, seed=2, device="cpu", filter_mode=filter_mode, dtype=dtype)
    lists = raycast.tile_bricks_reference(c.rays, c.boxes, c.eye, c.width)
    n_rays, n_bricks = c.carry.shape[0], c.slots.shape[0]
    runs = []
    for only in (None, lists):
        samples = torch.zeros(n_rays, dtype=torch.int32)
        used = torch.zeros(n_bricks, dtype=torch.int32)
        tile_used = torch.zeros_like(lists)
        out = raycast.march_exact_reference(
            c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params,
            max_steps=c.max_steps, samples=samples, used=used, width=c.width,
            only=only, tile_used=tile_used,
        )
        runs.append((out, samples, used, tile_used))
    return request.param, c, lists, runs


def test_brick_lists_cover_samples(march_lists):
    """(a) Every (tile, brick) at which a ray of the tile composites a
    sample is on the tile's list."""
    _name, _c, lists, runs = march_lists
    tile_used = runs[0][3]
    assert int(tile_used.sum()) > 0
    assert bool((tile_used <= lists).all())


def test_march_restricted_to_brick_lists_matches(march_lists):
    """(b) The plain march over each tile's listed bricks only composites
    the same samples: per-ray sample counts and per-brick use flags equal,
    and the image bit-equal (each chunk a listed brick drops composites
    nothing, so its closed-form fold adds exact zeros)."""
    _name, _c, _lists, ((out, samples, used, tu), (out_r, samples_r, used_r, tu_r)) = march_lists
    assert torch.equal(samples_r, samples) and torch.equal(used_r, used)
    assert torch.equal(tu_r, tu)
    assert torch.equal(out_r, out)


def test_brick_lists_leave_bricks_out(march_lists):
    """The lists are a real cut: every tile lists fewer than all 64
    bricks, and the eye's own brick is on every list when the eye is
    inside one."""
    name, c, lists, _runs = march_lists
    assert int(lists.sum(dim=-1).max()) < c.slots.shape[0]
    if MARCH_CASES[name][0] == "in_brick":
        lo, hi = c.boxes[:, 0:3], torch.stack([c.boxes[:, 3], c.boxes[:, 4], c.boxes[:, 5]], -1)
        eye = torch.as_tensor(c.eye)
        holds = ((lo <= eye) & (eye <= hi)).all(dim=-1)
        assert int(holds.sum()) == 1
        assert bool(lists[..., holds].all())


def test_brick_lists_of_one_brick_and_of_no_rays():
    """One brick filling the view: every tile with rays lists it.  A
    ragged last row leaves tiles without rays, and those list nothing; a
    zero direction widens its tile's cone to every brick."""
    c = exact_case("single", seed=0, device="cpu")
    lists = raycast.tile_bricks_reference(c.rays, c.boxes, c.eye, c.width)
    assert lists.shape == (256 // 8, 256 // 16, 1) and bool(lists.all())

    c = exact_case("bricks", seed=0, device="cpu")
    # Eight rows, and a ninth of 5 rays from the middle of the screen.
    mid = 35 * c.width + 40
    rays = torch.cat([c.rays[:, : 8 * c.width], c.rays[:, mid : mid + 5]], dim=1).contiguous()
    lists = raycast.tile_bricks_reference(rays, c.boxes, c.eye, c.width)
    assert lists.shape[:2] == (2, -(-c.width // 16))
    assert bool(lists[1, 1:].sum() == 0) and int(lists[1, 0].sum()) > 0
    rays = rays.clone()
    rays[:3, 0] = 0.0
    wide = raycast.tile_bricks_reference(rays, c.boxes, c.eye, c.width)
    assert bool(wide[0, 0].all()) and torch.equal(wide[0, 1:], lists[0, 1:])
