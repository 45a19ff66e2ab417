"""The port's mesh trainer over a brick set against the benchmark's plain
reference of the exact march over a set (``perfbench/reference/exact_set.py``),
and the program pieces the ``fit.exactset512`` cell drives, on the CPU.

* A 64³ smooth volume in 4³ bricks of 16³ with two ghost voxels (20³),
  bricked by ``data.lod_store.brick_volume`` and sorted front to back
  from the orbit's centre eye, 32² rays, 64 samples per unit, the early
  exit off, on ``make_mesh``'s 1×1 mesh: the forward, the per-brick
  density gradient, the TF gradient and one Adam step, two seeds.
* A one-brick set in the set reference against ``reference/exact.py``.
* The reference's stored order is the program's, at the cell's 8³ grid.
* ``brick_volume`` against ``testing.split_into_bricks``' former body.
* ``render_rays_sharded.host_reads``; the spans of ``make_train_step``
  and ``render_rays_sharded`` only while a profiler records.
* ``perfbench/work/k4_set`` against a hand count.
"""

import numpy as np
import pytest
import torch

from libre_tpu_torch.data.lod_store import brick_volume
from libre_tpu_torch.ops import rays as ray_ops
from libre_tpu_torch.ops.reference import Camera, RenderParams, max_steps_for_bricks
from libre_tpu_torch.parallel.mesh import make_mesh
from libre_tpu_torch.parallel.render import render_rays_sharded, shard_bricks_front_to_back
from libre_tpu_torch.train import InverseRenderProblem, init_state, make_train_step
from libre_tpu_torch.utils import profiling
from perfbench import inputs
from perfbench.reference import exact as ref_exact
from perfbench.reference import exact_set as ref_set
from perfbench.reference.sinks import Sinks
from perfbench.reference.train import Adam
from perfbench.reference.views import exact_rays, max_steps
from perfbench.work import k4_set

CPU = torch.device("cpu")
ORBIT = {"poses": 8, "distance": 1.5, "height": 0.15, "azimuth_deg": [-10.0, 10.0],
         "jitter_deg": 1.25}
SORT_EYE = np.float32([0.0, ORBIT["height"], ORBIT["distance"]])
GMIN, GMAX = (-0.5,) * 3, (0.5,) * 3
N, BLOCK, OVERLAP, RAYS, SPR, LR = 64, 16, 2, 32, 64, 0.05
# The forward: the same f32 operations, folded in another order (the
# plain K3 carries each ray across the bricks, the reference folds
# per-brick segments by the over operator); they read ~1e-7 apart.
FORWARD_ATOL = 1e-6
# The gradients, as a share of the largest entry: the plain K4 recomputes
# the march backward from the output, the reference differentiates its
# closed-form chunks by autograd and sums the TF's in float64; thousands
# of samples land in one TF texel (the benchmark's one-brick reference
# test holds the same share).
GRAD_SHARE = 1e-4
# One Adam step from the same gradient: the reference's Adam is Kingma and
# Ba's formula, torch's rounds another way; an f32 ulp or two of 0.5.
ADAM_ATOL = 1e-6


def _camera(seed):
    cam = inputs.orbit(ORBIT, RAYS, RAYS, seed)[seed % ORBIT["poses"]]
    return cam, Camera(cam["inv_proj"], cam["inv_mv"], cam["viewport"], cam["near"])


def _render_cfg(step):
    return {"step": step, "alpha_correction": 32 / SPR, "early_exit": 1.1, "range": (0.0, 1.0),
            "box": (GMIN, GMAX), "max_steps": max_steps([0.0] * 3, [BLOCK / N] * 3, step)}


def _case(seed):
    """The program's problem over the sorted set of a seeded volume, the
    mesh, the rays of one pose (program, reference), the TF, the volume."""
    volume = inputs.smooth_volume(N, seed, CPU)
    bricks, _ = shard_bricks_front_to_back(brick_volume(volume, BLOCK, OVERLAP), SORT_EYE, 1)
    params = RenderParams(n_samples_per_ray=SPR, max_samples_per_ray=32,
                          data_source_range=(0.0, 1.0), filter_mode="trilinear", early_exit=1.1)
    problem = InverseRenderProblem(
        bricks=bricks, global_min=GMIN, global_max=GMAX, params=params,
        max_steps=max_steps_for_bricks(bricks.world_min.numpy(), bricks.world_max.numpy(),
                                       params.step_size),
        width=RAYS)
    cam, camera = _camera(seed)
    eye, dirs, cos_z, _ = ray_ops.make_rays(camera.inv_proj, camera.inv_mv, camera.viewport,
                                            device=CPU)
    rays = (eye, dirs.reshape(-1, 3), ray_ops.near_plane_t(cos_z.reshape(-1), camera.near))
    ref_rays = exact_rays(cam, params.step_size, GMIN, GMAX, CPU)
    tf = inputs.color_map(256, CPU)
    return problem, make_mesh(devices=[CPU]), rays, ref_rays, tf, volume


@pytest.mark.parametrize("seed", [3, 12])
def test_set_trainer_against_the_set_reference(seed):
    problem, mesh, rays, ref_rays, tf, volume = _case(seed)
    cfg = _render_cfg(problem.params.step_size)
    ref_bricks = ref_set.brick_set(volume, BLOCK, OVERLAP, SORT_EYE.tolist())
    assert torch.equal(ref_bricks["data"], problem.bricks.data)
    assert torch.equal(ref_bricks["world_min"], problem.bricks.world_min)
    with torch.no_grad():
        got = problem.render(mesh, problem.bricks.data, tf, *rays)
    want = ref_set.render(ref_bricks, tf, ref_rays, cfg, block=300)
    assert float(want[:, 3].max()) > 0.1  # the view sees the volume
    torch.testing.assert_close(got, want, rtol=0, atol=FORWARD_ATOL)

    # One step of the mesh trainer from a flat 0.5 against the truth's render.
    start = problem.bricks._replace(data=torch.full_like(problem.bricks.data, 0.5))
    problem = InverseRenderProblem(start, GMIN, GMAX, problem.params, problem.max_steps, RAYS)
    factory = lambda p: torch.optim.Adam(p, lr=LR)  # noqa: E731
    state = init_state(problem, tf, factory, mesh=mesh)
    loss = float(make_train_step(problem, factory, mesh)(state, *rays, want))
    (density,) = state.params["density"]
    sinks = Sinks(start.data.numel(), 256, CPU)
    ref_loss = ref_set.loss_and_grads(start.data.clone(), tf, ref_bricks, ref_rays, want, cfg,
                                      sinks, block=300)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    d_ref = sinks.volume.reshape(start.data.shape)
    for mine, theirs in ((density.grad, d_ref), (state.params["tf"].grad, sinks.tf.float())):
        scale = float(theirs.abs().max())
        assert scale > 0.0
        assert float((mine - theirs).abs().max()) <= GRAD_SHARE * scale
    # Per brick: every brick the rays reach takes its own gradient.
    per_brick = d_ref.abs().flatten(1).amax(dim=1)
    assert int((per_brick > 0).sum()) > 8
    assert torch.equal(density.grad.abs().flatten(1).amax(dim=1) > 0, per_brick > 0)

    leaves = {"density": start.data.clone(), "tf": tf.clone()}
    Adam(leaves, LR).step(leaves, {"density": density.grad, "tf": state.params["tf"].grad})
    leaves["tf"].clamp_(0.0, 1.0)
    torch.testing.assert_close(density.detach(), leaves["density"], rtol=0, atol=ADAM_ATOL)
    torch.testing.assert_close(state.params["tf"].detach(), leaves["tf"], rtol=0, atol=ADAM_ATOL)


@pytest.mark.parametrize("overlap", [0, 2])
def test_one_brick_set_is_the_exact_reference(overlap):
    n = 16
    cam, _ = _camera(5)
    volume = inputs.smooth_volume(n, 5, CPU)
    tf = inputs.color_map(256, CPU)
    step = 1.0 / n
    cfg = {"step": step, "alpha_correction": 2.0, "early_exit": 1.1, "range": (0.0, 1.0),
           "box": (GMIN, GMAX), "max_steps": max_steps(GMIN, GMAX, step)}
    rays = exact_rays(cam, step, GMIN, GMAX, CPU)
    one = ref_set.brick_set(volume, n, overlap, SORT_EYE.tolist())
    assert one["data"].shape == (1,) + (n + 2 * overlap,) * 3
    want = ref_exact.render(volume, tf, rays, cfg, block=100)
    got = ref_set.render(one, tf, rays, cfg, block=100)
    assert float(want[:, 3].max()) > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n, block", [(8, 1), (N, BLOCK)])
def test_reference_order_is_the_programs(n, block):
    """At (8, 1) the boxes are those of the cell's 512³ in bricks of 64³."""
    program, _ = shard_bricks_front_to_back(brick_volume(np.zeros((n,) * 3, np.float32), block, 0),
                                            SORT_EYE, 1)
    ref = ref_set.brick_set(torch.zeros((n,) * 3), block, 0, SORT_EYE.tolist())
    assert torch.equal(program.world_min, ref["world_min"])
    assert torch.equal(program.world_max, ref["world_max"])


def _former_split_into_bricks(volume_zyx, n_split, overlap):
    """``testing.split_into_bricks`` as it was before it called
    ``brick_volume``."""
    volume = np.asarray(volume_zyx, np.float32)
    _nz, _ny, nx = volume.shape
    bs = nx // n_split
    padded = np.pad(volume, overlap, mode="edge")
    pdim = bs + 2 * overlap
    data, wmin, wmax = [], [], []
    for bx in range(n_split):
        for by in range(n_split):
            for bz in range(n_split):
                z0, y0, x0 = bz * bs, by * bs, bx * bs
                data.append(padded[z0:z0 + pdim, y0:y0 + pdim, x0:x0 + pdim])
                wmin.append(np.float32([x0, y0, z0]) / nx - 0.5)
                wmax.append(np.float32([x0 + bs, y0 + bs, z0 + bs]) / nx - 0.5)
    n = len(data)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.stack(a), np.float32))

    return (t(data), t(wmin), t(wmax), t([np.full(3, overlap / pdim, np.float32)] * n),
            t([np.full(3, (overlap + bs) / pdim, np.float32)] * n))


@pytest.mark.parametrize("n, n_split, overlap", [(16, 2, 2), (64, 4, 2), (24, 3, 1), (8, 1, 0)])
def test_brick_volume_is_the_former_split(n, n_split, overlap):
    from libre_tpu_torch.testing import split_into_bricks

    volume = np.random.default_rng(n).random((n,) * 3, dtype=np.float32)
    want = _former_split_into_bricks(volume, n_split, overlap)
    for got in (split_into_bricks(volume, n_split, overlap, device="cpu"),
                brick_volume(torch.from_numpy(volume), n // n_split, overlap)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_brick_volume_refuses_a_ragged_cut():
    with pytest.raises(ValueError, match="multiples of 16"):
        brick_volume(np.zeros((16, 16, 24), np.float32), 16)


def test_host_reads_counts_each_call():
    problem, _mesh, rays, _ref, tf, _v = _case(3)
    before = render_rays_sharded.host_reads
    for mesh in (make_mesh(devices=[CPU]), make_mesh(n_brick=2, n_ray=2, devices=[CPU] * 4)):
        bricks, _ = shard_bricks_front_to_back(problem.bricks, SORT_EYE, mesh.shape["brick"])
        with torch.no_grad():
            render_rays_sharded(mesh, bricks, tf, *rays, problem.params, GMIN, GMAX,
                                problem.max_steps, width=RAYS // 2)
    assert render_rays_sharded.host_reads - before == 2 * 5  # four box tables and the eye


def test_set_step_spans_only_under_a_profiler(monkeypatch):
    problem, mesh, rays, _ref, tf, _v = _case(12)
    factory = lambda p: torch.optim.Adam(p, lr=LR)  # noqa: E731
    state = init_state(problem, tf, factory, mesh=mesh)
    step = make_train_step(problem, factory, mesh)
    target = torch.zeros((RAYS * RAYS, 4))
    opened = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    step(state, *rays, target)
    assert not [n for n in opened if n.startswith("libre.")]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, *rays, target)
    names = [e.name for e in prof.events() if e.name.startswith("libre.")]
    for name in ("libre.train.step", "libre.train.loss", "libre.train.backward",
                 "libre.train.update", "libre.shard.rays", "libre.shard.composite",
                 "libre.exact.forward", "libre.exact.backward"):
        assert names.count(name) == 1, (name, names)
    assert profiling.span("libre.after") is profiling.NO_SPAN


def test_k4_set_work_is_the_hand_count():
    # 2 bricks of 68³, 1000 samples, 10 rays, a 256-entry TF.
    voxels = 2 * 68 ** 3
    assert k4_set.bytes_ops(voxels=voxels, samples=1000, n_rays=10, n_bricks=2, n_tf=256,
                            diff_tf=True) == (5_030_912 + 640 + 8192, 211_000 + 540)
    assert k4_set.bytes_ops(voxels=voxels, samples=1000, n_rays=10, n_bricks=2, n_tf=256,
                            diff_tf=False) == (5_030_912 + 640 + 4096, 193_000 + 540)
