"""The port's histograms (``libre_tpu_torch.ops.histogram_ops`` and
``RenderEngine.accumulate_histogram``) against the JAX package's, on the
CPU.

* ``compute_brick_histogram``: uint8, uint16, float and uniform bricks,
  with and without overlap, with and without a data range: bins exactly
  the JAX function's (the f64 normalisation cast to f32 before the bin
  index is taken in f32), and range ends equal;
* ``Histogram``: merge, range and bin-count errors, indices and ratios;
* ``render_bricked(collect_histogram=True)`` and
  ``render(collect_histogram=True)`` on small engines, in core, out of
  core at a tiny budget and asynchronous once converged: bins exactly the
  JAX engine's for uint8, uint16 and float volumes; the
  ``relative_viewport`` dedupe of a 2×1 split counts each brick once.
"""

import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import Frustum as FrustumJ, look_at, perspective
from libre_tpu.core.volume_info import DataType as DataTypeJ
from libre_tpu.data.datasource import DataSource as DataSourceJ, load_plugins as plugins_j
from libre_tpu.ops import histogram_ops as hist_j
from libre_tpu.ops.reference import Camera as CameraJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.core.frustum import Frustum as FrustumT
from libre_tpu_torch.core.volume_info import DataType as DataTypeT
from libre_tpu_torch.data.datasource import DataSource as DataSourceT, load_plugins as plugins_t
from libre_tpu_torch.ops import histogram_ops as hist_t
from libre_tpu_torch.ops.reference import Camera as CameraT
from libre_tpu_torch.render.engine import RenderEngine as EngineT

torch.set_num_threads(1)
plugins_j()
plugins_t()


def brick(kind, shape=(12, 10, 14), seed=0):
    """A seeded (Z, Y, X) brick of ``kind``; the float kinds put values
    on and next to bin edges of their own range."""
    rng = np.random.default_rng(seed)
    if kind == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "uint16":
        return rng.integers(0, 65536, shape).astype(np.uint16)
    if kind == "float":
        edges = rng.integers(0, 257, shape) / 256.0
        jitter = rng.choice([0.0, 1e-9, -1e-9, 3e-8], shape)
        return (0.25 + 3.0 * (edges + jitter)).astype(np.float32)
    if kind == "float_wide":
        return rng.standard_normal(shape).astype(np.float32) * 1e3
    if kind == "uniform":
        return np.full(shape, 7, np.uint8)
    if kind == "uniform_float":
        return np.full(shape, 0.3, np.float32)
    raise ValueError(kind)


DTYPES = {
    "uint8": "uint8", "uint16": "uint16", "float": "float32",
    "float_wide": "float32", "uniform": "uint8", "uniform_float": "float32",
}


@pytest.mark.parametrize("overlap", [(0, 0, 0), (1, 1, 1), (2, 1, 0)])
@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("with_range", [False, True])
def test_brick_histogram_matches_jax(kind, overlap, with_range):
    data = brick(kind)
    dt = DTYPES[kind]
    rng = None
    if with_range:
        rng = DataTypeT(dt).default_range if dt != "float32" else (-1.0, 2.5)
    want = hist_j.compute_brick_histogram(data, overlap, DataTypeJ(dt), data_range=rng)
    got = hist_t.compute_brick_histogram(data, overlap, DataTypeT(dt), data_range=rng,
                                         device="cpu")
    assert got.bins.dtype == np.uint64 and got.bins.shape == (256,)
    np.testing.assert_array_equal(got.bins, want.bins)
    assert (got.min_value, got.max_value) == (want.min_value, want.max_value)
    ox, oy, oz = overlap
    interior = (12 - 2 * oz) * (10 - 2 * oy) * (14 - 2 * ox)
    assert got.sum == interior
    if kind == "uniform_float" and not with_range:
        assert got.bins[0] == interior and got.min_value == got.max_value  # the fast path


def test_brick_histogram_bin_edges_and_other_bin_counts():
    """Values whose f64 normalisation sits just below a bin edge land in
    the bin the f32 rounding gives, as in the JAX function; 64 bins take
    the numpy path of both."""
    lo, hi = 0.0, 3.0
    k = np.arange(1, 256, dtype=np.float64)
    vals = np.concatenate([k * (hi - lo) / 256 * (1 - 1e-9), k * (hi - lo) / 256])
    data = vals.astype(np.float64).reshape(1, 2, -1).astype(np.float32)
    for n_bins in (256, 64):
        want = hist_j.compute_brick_histogram(data, (0, 0, 0), DataTypeJ.FLOAT, (lo, hi), n_bins)
        got = hist_t.compute_brick_histogram(data, (0, 0, 0), DataTypeT.FLOAT, (lo, hi), n_bins,
                                             device="cpu")
        np.testing.assert_array_equal(got.bins, want.bins)
    values01 = torch.tensor([0.0, 0.5, 255.5 / 256, 1.0, 1.5, -0.2], dtype=torch.float32)
    np.testing.assert_array_equal(
        hist_t._bincount_256(values01).numpy(),
        np.asarray(hist_j._bincount_256(values01.numpy())),
    )


def test_histogram_merge_and_errors():
    a_bins = np.arange(8, dtype=np.uint64)
    b_bins = np.array([0, 0, 3, 0, 0, 0, 1, 0], np.uint64)
    for mod in (hist_t, hist_j):
        a, b = mod.Histogram(a_bins.copy(), 0.0, 1.0), mod.Histogram(b_bins.copy(), 0.0, 1.0)
        c = a + b
        np.testing.assert_array_equal(c.bins, a_bins + b_bins)
        np.testing.assert_array_equal(a.bins, a_bins)  # + leaves its operands
        a += b
        np.testing.assert_array_equal(a.bins, c.bins)
        with pytest.raises(ValueError, match="incompatible ranges"):
            a += mod.Histogram(b_bins.copy(), 0.0, 2.0)
        with pytest.raises(ValueError, match="bin counts"):
            a += mod.Histogram(np.zeros(4, np.uint64), 0.0, 1.0)
    got, want = hist_t.Histogram(b_bins, 0.0, 1.0), hist_j.Histogram(b_bins, 0.0, 1.0)
    assert (got.sum, got.min_index, got.max_index, got.is_empty(), got.get_range()) == (
        want.sum, want.min_index, want.max_index, want.is_empty(), want.get_range())
    assert [got.get_ratio(i) for i in range(8)] == [want.get_ratio(i) for i in range(8)]
    empty = hist_t.Histogram(np.zeros(8, np.uint64), 0.0, 1.0)
    assert empty.is_empty() and empty.min_index == empty.max_index == 0
    assert empty.get_ratio(3) == 0.0


# --------------------------------------------------------------- engines
def view(eye=(0.3, 0.2, 1.4), w=16, h=16):
    proj = perspective(50.0, w / h, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w, h),
        near=0.1,
    )
    return CameraJ(**kw), CameraT(**kw), FrustumJ(mv, proj), FrustumT(mv, proj)


def uri(dtype, n=32, block=8):
    return f"mem://#{n},{n},{n},{block}?pattern=gradient&datatype={dtype}"


def assert_same(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got.bins, np.asarray(want.bins))
        assert (got.min_value, got.max_value) == (want.min_value, want.max_value)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float"])
@pytest.mark.parametrize("mode", ["in_core", "out_of_core", "async"])
def test_render_bricked_histogram_matches_jax(dtype, mode):
    cam_j, cam_t, fr_j, fr_t = view()
    mb = 64 if mode != "out_of_core" else 0.1
    eng_t = EngineT(DataSourceT(uri(dtype)), max_gpu_cache_mb=mb, device="cpu")
    eng_j = EngineJ(DataSourceJ(uri(dtype)), max_gpu_cache_mb=64, filter_mode="trilinear")
    kw = dict(screen_space_error=1.0, n_planes=16, collect_histogram=True)
    if mode == "async":
        img, stats = eng_t.render_bricked(cam_t, fr_t, synchronous=False, **kw)
        assert not stats.rendering_done and stats.histogram is None  # nothing resident yet
        for _ in range(20):
            for f in stats.pending_uploads:
                f.result(timeout=60)
            img, stats = eng_t.render_bricked(cam_t, fr_t, synchronous=False, **kw)
            if stats.rendering_done:
                break
        assert stats.rendering_done
    else:
        img, stats = eng_t.render_bricked(cam_t, fr_t, **kw)
    if mode == "out_of_core":
        assert stats.n_passes > 1
    _img_j, stats_j = eng_j.render_bricked(cam_j, fr_j, **kw)
    assert stats.n_available == stats_j.n_available > 1
    assert_same(stats.histogram, stats_j.histogram)
    h = stats.histogram
    if dtype != "float":
        # Every brick of the set has the dtype's range: all are merged.
        assert h.sum == stats.n_available * 8 ** 3
    else:
        # Float bricks each span their own range: the first brick's, the
        # others purged and skipped while the range converges.
        assert h.sum % 8 ** 3 == 0 and 0 < h.sum < stats.n_available * 8 ** 3
    # A second frame reads the cached per-brick histograms.
    _img, again = eng_t.render_bricked(cam_t, fr_t, **kw)
    assert_same(again.histogram, h)


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float"])
def test_render_histogram_matches_jax(dtype):
    """``render``'s third value: the histogram of the front-to-back set."""
    cam_j, cam_t, fr_j, fr_t = view((0.2, 0.3, 1.3))
    slot_bytes = EngineT(DataSourceT(uri(dtype)), device="cpu").atlas.slot_bytes
    mb = 13 * slot_bytes * 2 / 2**20  # a 13-slot atlas: passes of 12 bricks
    eng_t = EngineT(DataSourceT(uri(dtype)), max_gpu_cache_mb=mb, filter_mode="trilinear",
                    device="cpu")
    eng_j = EngineJ(DataSourceJ(uri(dtype)), max_gpu_cache_mb=mb, filter_mode="trilinear")
    kw = dict(screen_space_error=1.0, collect_histogram=True)
    _img, stats, got = eng_t.render(cam_t, fr_t, **kw)
    _img, stats_j, want = eng_j.render(cam_j, fr_j, marcher="xla", **kw)
    assert stats.n_passes > 1 and stats.n_available == stats_j.n_available
    assert_same(got, want)
    assert eng_t.render(cam_t, fr_t, screen_space_error=1.0)[2] is None


def tile_view(eye, side, w=16, h=16):
    """The camera and frustum of the left (side -1) or right (+1) half of
    a (w, h) view: the full projection with NDC x mapped 2x ∓ 1, so each
    half spans [-1, 1] of its own NDC."""
    proj = perspective(50.0, w / h, 0.1, 15.0)
    to_tile = np.eye(4, dtype=np.float32)
    to_tile[0, 0], to_tile[0, 3] = 2.0, -float(side)
    proj = (to_tile.astype(np.float64) @ proj.astype(np.float64)).astype(np.float32)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, w // 2, h),
        near=0.1,
    )
    return CameraJ(**kw), CameraT(**kw), FrustumJ(mv, proj), FrustumT(mv, proj)


def test_relative_viewport_split_counts_each_brick_once():
    """Two channels side by side, each with its own half of the frustum
    and its share of the viewport ([0, .5] and [.5, 1] of x): each brick's
    centre falls in exactly one, so their histograms sum to the whole
    frame's, and each equals the JAX engine's."""
    eye = (0.6, 0.3, 1.2)
    _cam_j, cam_t, _fr_j, fr_t = view(eye)
    eng_t = EngineT(DataSourceT(uri("uint8")), max_gpu_cache_mb=64, device="cpu")
    eng_j = EngineJ(DataSourceJ(uri("uint8")), max_gpu_cache_mb=64, filter_mode="trilinear")
    kw = dict(screen_space_error=1.0, n_planes=16, collect_histogram=True)
    whole = eng_t.render_bricked(cam_t, fr_t, **kw)[1].histogram
    halves, counted = [], 0
    for side, rv in ((-1, (0.0, 0.0, 0.5, 1.0)), (1, (0.5, 0.0, 0.5, 1.0))):
        tcam_j, tcam_t, tfr_j, tfr_t = tile_view(eye, side)
        got = eng_t.render_bricked(tcam_t, tfr_t, relative_viewport=rv, **kw)[1].histogram
        want = eng_j.render_bricked(tcam_j, tfr_j, relative_viewport=rv, **kw)[1].histogram
        assert_same(got, want)
        halves.append(got)
        counted += sum(eng_t._center_in_viewport(tfr_t, n, rv)
                       for n in eng_t.select(tfr_t, 16, 1.0))
    nodes = eng_t.select(fr_t, 16, 1.0)
    assert 0 < halves[0].sum < whole.sum and 0 < halves[1].sum < whole.sum
    np.testing.assert_array_equal(halves[0].bins + halves[1].bins, whole.bins)
    assert counted == len(nodes) and whole.sum == len(nodes) * 8 ** 3


def test_histogram_skips_bricks_that_fail_to_load(monkeypatch):
    """A brick whose load fails is skipped (CacheLoadError), not fatal."""
    _cam_j, cam_t, _fr_j, fr_t = view()
    eng = EngineT(DataSourceT(uri("uint8")), max_gpu_cache_mb=64, device="cpu")
    nodes = eng.select(fr_t, 16, 1.0)
    bad = nodes[1].id
    real = eng._load_brick

    def load(cache_id):
        if cache_id == bad:
            raise OSError("unreadable brick")
        return real(cache_id)

    monkeypatch.setattr(eng.data_cache, "_loader", load)
    h = eng.accumulate_histogram(nodes)
    assert h.sum == (len(nodes) - 1) * 8 ** 3
