"""The port's dense trainer (``ShearWarpProblem``, classification "pre")
against the benchmark's plain reference of the pre-classified shear-warp
render (``perfbench/reference/dense_pre.py``), and the program pieces the
``fit.dense256`` cell reads, on the CPU.

* A 24³ volume and a 256-entry TF drawn uniform in [0, 1] (every tap and
  TF texel carries a gradient), 48 planes, 4 orbit views of 24² slope
  rays, two seeds: the views, the loss, both gradients, and three Adam
  steps with the clamp.
* ``precompute_classified_volume.calls``: one a view in "pre", none in
  "post".
* The dense spans and the TF gathers' only while a profiler records.
* ``reference.dense_pre.samples_inside`` against the fetch mask of
  ``reference.shearwarp.planes``; ``Float32Products``.
* ``perfbench/work/dense_pre`` against a hand count.
"""

import numpy as np
import pytest
import torch

from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops.reference import RenderParams
from libre_tpu_torch.train import ShearWarpProblem, make_shearwarp_train_step
from libre_tpu_torch.utils import profiling
from perfbench import inputs
from perfbench.drivers.common import program_camera
from perfbench.reference import dense_pre as ref_dense
from perfbench.reference import shearwarp as ref_sw
from perfbench.reference.train import Adam
from perfbench.work import dense_pre

CPU = torch.device("cpu")
ORBIT = {"poses": 8, "distance": 1.5, "height": 0.15, "azimuth_deg": [-10.0, 10.0],
         "jitter_deg": 1.25}
WMIN, WMAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)
N, K, RAYS, MSR, LR, RANGE = 24, 48, 24, 32, 0.03, (0.0, 1.0)
# A view: the same f32 geometry, but the resample's grouping (dense two-tap
# products against lerps of gathered taps) and the composite's (one closed
# form against chunks of 32 planes); they read up to 7e-7 apart here.
VIEW_ATOL = 3e-6
# The loss: a sum of those views' squared errors.
LOSS_RTOL = 1e-5
# The gradients, as a share of the leaf's largest entry: the program sums
# each TF gather's cotangent in f32 by bincount, the reference in float64;
# autograd through the products against the reference's sink of the
# classified volume carried back through the classification once.
GRAD_SHARE = 1e-5
# Adam from the same gradient: the reference's Adam is Kingma and Ba's
# formula, torch's rounds another way; an f32 ulp or two of a leaf.  (From
# the reference's own gradient a near-zero entry, behind an opaque sample,
# may flip its sign and move 2·lr the other way: the gradients are held to
# each other at every step instead.)
ADAM_ATOL = 1e-6


def _case(seed, classification="pre"):
    """The program's problem over 4 views, their cameras, the seeded
    leaves (volume, TF) and seeded targets."""
    cams = inputs.orbit(ORBIT, RAYS, RAYS, seed)[::2][:4]
    params = RenderParams(n_samples_per_ray=K, max_samples_per_ray=MSR,
                          data_source_range=RANGE, filter_mode="trilinear")
    swp = sw.ShearWarpParams(n_planes=K, inter_size=(RAYS, RAYS), slope_margin=0.02,
                             classification=classification)
    problem = ShearWarpProblem.from_cameras([program_camera(c) for c in cams], WMIN, WMAX,
                                            params, swp)
    g = torch.Generator().manual_seed(seed)
    volume = torch.rand((N, N, N), generator=g)
    tf = torch.rand((256, 4), generator=g)
    targets = [torch.rand((RAYS, RAYS, 4), generator=g) for _ in cams]
    return problem, cams, volume, tf, targets


def _geoms(cams):
    geom = {"k_planes": K, "inter_size": (RAYS, RAYS), "world_min": WMIN, "world_max": WMAX,
            "slope_margin": 0.02, "max_samples_per_ray": MSR}
    return [ref_dense.view_geometry(c, (N, N, N), geom, CPU) for c in cams]


def _program_step(problem, volume, tf):
    leaves = {"volume": volume.clone().requires_grad_(), "tf": tf.clone().requires_grad_()}
    opt = torch.optim.Adam([leaves["volume"], leaves["tf"]], lr=LR)
    return leaves, make_shearwarp_train_step(problem, opt)


@pytest.mark.parametrize("seed", [3, 12])
def test_dense_trainer_against_the_reference(seed):
    problem, cams, volume, tf, targets = _case(seed)
    geoms = _geoms(cams)
    with torch.no_grad():
        got = problem.render_views(None, volume, tf)
    want = ref_dense.render_views(volume, tf, geoms, RANGE)
    for a, b in zip(got, want):
        assert float(b[..., 3].max()) > 0.5  # each view sees the volume
        torch.testing.assert_close(a, b, rtol=0, atol=VIEW_ATOL)

    leaves, step = _program_step(problem, volume, tf)
    loss = float(step(leaves, targets))
    ref_loss, grads = ref_dense.loss_and_grads(volume, tf, geoms, targets, RANGE)
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    for name in ("volume", "tf"):
        mine, theirs = leaves[name].grad, grads[name]
        scale = float(theirs.abs().max())
        assert scale > 0.0
        assert float((mine - theirs).abs().max()) <= GRAD_SHARE * scale, name
        # every voxel some tap reads, and every texel some voxel reads
        assert float((theirs != 0).float().mean()) > 0.5, name
        assert torch.equal(mine != 0, theirs != 0) or name == "tf", name


@pytest.mark.parametrize("seed", [3, 12])
def test_three_adam_steps_with_the_clamp(seed):
    """Each step's gradients against the reference's at the program's own
    leaves, and the leaves against the reference's Adam and clamp applied
    to the program's gradients."""
    problem, cams, volume, tf, targets = _case(seed)
    geoms = _geoms(cams)
    leaves, step = _program_step(problem, volume, tf)
    ref = {"volume": volume.clone(), "tf": tf.clone()}
    adam = Adam(ref, LR)
    clamped = 0
    for _ in range(3):
        _loss, grads = ref_dense.loss_and_grads(ref["volume"], ref["tf"], geoms, targets, RANGE)
        step(leaves, targets)
        mine = {k: v.grad for k, v in leaves.items()}
        for name in ("volume", "tf"):
            scale = float(grads[name].abs().max())
            assert float((mine[name] - grads[name]).abs().max()) <= GRAD_SHARE * scale, name
        adam.step(ref, mine)
        clamped += sum(int(((v < 0) | (v > 1)).sum()) for v in ref.values())
        for v in ref.values():
            v.clamp_(0.0, 1.0)
        for name in ("volume", "tf"):
            torch.testing.assert_close(leaves[name].detach(), ref[name], rtol=0,
                                       atol=ADAM_ATOL)
    assert clamped > 0  # the clamp acts


@pytest.mark.parametrize("classification, per_view", [("pre", 1), ("post", 0)])
def test_classify_calls_count_one_a_view(classification, per_view):
    problem, _views, volume, tf, _targets = _case(5, classification)
    before = sw.precompute_classified_volume.calls
    with torch.no_grad():
        problem.render_views(None, volume, tf)
    assert sw.precompute_classified_volume.calls - before == per_view * len(problem.plans)


def test_dense_spans_only_under_a_profiler(monkeypatch):
    problem, _views, volume, tf, targets = _case(7)
    leaves, step = _program_step(problem, volume, tf)
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    step(leaves, targets)
    assert not [n for n in opened if n.startswith("libre.")]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(leaves, targets)
    names = [e.name for e in prof.events() if e.name.startswith("libre.")]
    views = len(problem.plans)
    for name, count in (("libre.train.step", 1), ("libre.dense.forward", views),
                        ("libre.dense.classify", views), ("libre.tf.take_rows", 2 * views),
                        ("libre.tf.take_rows.backward", 2 * views)):
        assert names.count(name) == count, (name, names)
    assert profiling.span("libre.after") is profiling.NO_SPAN


def test_samples_inside_is_the_fetch_mask():
    _problem, cams, _volume, _tf, _targets = _case(9)
    for tab, window, shape, _axis in _geoms(cams):
        count = ref_sw.count_work(tab, shape, window)
        assert 0 < ref_dense.samples_inside(tab, window) == count < K * RAYS * RAYS


def test_float32_products_sets_tf32_off_and_restores():
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with ref_dense.Float32Products():
            assert [f.allow_tf32 for f in flags] == [False, False]
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v


def test_dense_pre_work_is_the_hand_count():
    # 10³ voxels, 1000 samples, 20 rays, a 256-entry TF.
    assert dense_pre.bytes_ops(voxels=1000, samples=1000, n_rays=20, n_tf=256) == (
        8000 + 8192 + 960, 54_000 + 404_000)
