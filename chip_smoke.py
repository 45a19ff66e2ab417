#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libre_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (any failure exits non-zero):

1. the card: CUDA present, compute capability 9.0, full-f32 matmuls;
   prints ``nvidia-smi``'s name and power limit;
2. builds every hand-written kernel from ``libre_tpu_torch/csrc`` and
   prints the build seconds;
3. kernel vs plain PyTorch on seeded inputs (SENTINEL holes, two clip
   planes, inactive planes, a saturating transfer function that fires
   the early exit) at 96×80 rays × 128 planes and at the slice shape
   (512² rays × 512 planes over a 512³ store), from every view of
   ``testing.SWEEP_VIEWS`` (on axis, the eye inside the volume, oblique):
   bit-equal, and the plain plane lists (``tile_planes_reference``) a
   superset of the planes each tile fetches at;
4. the main path: ``render_cli.main`` on a 512³ uint8 ``mem://`` volume
   at 512×512 (default LOD selection: a mixed-LOD set), then an 8-pose
   orbit through ``RenderEngine.render_bricked`` at screen-space error 1
   (all 4096 finest bricks, a 512³ store) within one major axis, so
   frames 2-8 reuse the cached store; the sweep kernel must launch once
   per frame;
5. kernel vs plain on the main path's own operands, bit-equal (timed,
   with the work behind the time: active planes, rays that fetch, early
   exits, samples fetched, planes listed per tile), the same for the
   CLI frame's recorded launch, and the port on the card vs the port on
   the CPU on a small volume;
6. the backward kernel vs plain PyTorch on seeded operands at 96×80 rays
   × 128 planes on every field of ``testing.FIELDS`` (random, flat, top,
   smooth) and at 512² rays × 512 planes over a random 512³ store, with
   the early exit off (1.1, the training setting) and on (0.999,
   saturating TF), the TF gradient on and off;
7. the training path: ``fit`` recovers the orbit's 512³ store and the TF
   from 4 orbit views (512² slope grids, K = 512) in 5 Adam steps from a
   flat init; every step launches the sweep and the backward kernel once
   per view; a checkpoint round trip; step and plain times; the backward
   kernel vs plain on view 0 over the trained store and over the truth
   store, each timed with the TF gradient on and off (samples/s, share of
   the bound); K1 on view 0 bit-equal to plain, with its bound;
8. the exact marcher K3 vs plain PyTorch on seeded operands: the
   ``bench_exact`` shape (one 64³ f32 brick, 256² rays, 512 samples per
   ray) and a scattered 64-brick uint8 atlas with clip planes and a carry
   in, from every view of ``testing.EXACT_BRICK_VIEWS`` (a saturating TF
   off axis; the eye inside the volume, inside a brick; rays along brick
   faces; a jittered sample), nearest and trilinear: images, per-brick
   use flags equal, per-ray sample counts equal but on rays the early
   exit ended, and the plain brick lists (``tile_bricks_reference``) a
   superset of the bricks each tile samples;
9. the exact main path: ``render_cli --renderer pallas-exact`` and then
   ``--renderer xla`` on the 512³ volume at 512×512 (the same frame), and
   an 8-pose orbit through ``RenderEngine.render(marcher="pallas")`` at
   screen-space error 1 (all 4096 finest bricks, 512 samples per ray) on
   the bricked orbit's engine; K3 must launch once per pass per sample;
   frame, select and kernel times and the work behind them (samples
   composited, bricks sampled, bricks listed per tile, rays ended by the
   early exit); K3 on the CLI frames' recorded launches;
10. K3 vs plain on a 64×64 window of the orbit view's rays (the plain
   version over all 512² rays and 4096 bricks would take minutes), with
   phase 8's checks of counts and lists;
11. the exact path on the card vs on the CPU, on a small volume through a
   9-slot atlas (passes of 8 bricks) with 2 jittered samples per pixel;
12. the exact backward K4 vs plain PyTorch on seeded operands, early exit
   off: the ``exact_fwd_bwd`` shape (one 64³ f32 brick, 256² rays, 512
   samples per ray) on every field of ``testing.FIELDS`` and a (24, 144,
   136) random brick with two clip planes and a jittered sample, nearest
   and trilinear, the TF gradient on and off; an autograd round trip of
   ``render_exact_diff`` on the card vs the plain backward; the fwd+bwd
   rate at the ``exact_fwd_bwd`` shape, K4 timed with the TF gradient on
   and off;
13. the exact training path at full width: ``init_exact_state`` from a
   flat 0.5 volume, ``make_exact_train_step`` with Adam (lr 5e-2) for 5
   steps over 4 views (512² rays, 512 samples per ray, trilinear) of a
   512³ smooth ground truth; K3 and K4 must launch once per step and the
   loss of view 0 must fall; step, kernel and plain times, samples per
   view, K4 vs plain on the whole of view 0 over the trained volume and
   over the ground truth (three seeded cotangents, K4 twice on each, its
   TF gradient also against the plain version over float64 operands),
   each timed with the TF gradient on and off; K3's bound on view 0; K3
   (with its sample counts) and K4 vs plain on a 64×64 window of it;
14. the exact trainer on the card vs on the CPU: 2 SGD steps on a 32³
   volume seen by 24×20 rays;
15. the dense pre-classified sweep K5 vs plain PyTorch on seeded
   operands: the JAX package's dense test scene (20×24×28, a (24, 40)
   grid, 24 planes) from all four eyes, with empty slices and a
   saturating TF, a 512³ RGBA stack under 512² rays × 512 planes, and a
   stack with empty slices under every view of ``testing.SWEEP_VIEWS``
   (ragged tiles, K ≠ Na and K = Na): bit-equal, and the plain plane
   lists a superset of the planes each tile composites at;
16. the dense main path: ``render_cli --renderer shearwarp`` on the 512³
   volume at 512×512 (level 4, a 2 GiB classified stack, K = 512), then
   the 8-pose orbit through ``RenderEngine.render_shearwarp``, frames 2-8
   on the cached stack; K5 must launch once per frame and no plain
   version may run; first-frame split (level assembly, classify), steady
   frames, K5 (bit-equal) and plain times on the last pose and the work
   behind them: planes listed per tile and composited at;
17. the dense path on the card (K5) vs on the CPU (the plain pipeline) on
   a small volume, and the autograd Function's forward and gradients on
   the card vs on the CPU.
18. the out-of-core slab multipass and the asynchronous uploads at 1024³
   (``phase_out_of_core``), with one out-of-core frame and one
   asynchronous run rendered while a side stream is current, each
   bit-equal to its default-stream frame;
19. the gather probes P1-P17 (``libre_tpu_torch/benchmarks``, the JAX
   package's ``benchmarks/probe_*.py``) through each module's ``main`` at
   full shape: each probe's kernel (``csrc/probe_take.cu``,
   ``probe_take_along.cu``, ``probe_tf_nearest.cu``,
   ``probe_tf_linear.cu``) bit-equal to its plain version and to its
   PyTorch library call, timed in a CUDA graph and from Python; the four
   kernels' launch counts set to 0 before and read after;
20. the interactive service (``phase_serve``): ``RenderService`` on the
   512³ volume at 512×512 driven over HTTP on 127.0.0.1 (orbit, colormap,
   the exact renderer, the 2×2 layout through the wall, an asynchronous
   frame), K1's and
   K3's counts set to 0 before and read after; each served frame
   bit-equal to the engine's own frame, each histogram equal to numpy's
   bincount over the frame's bricks; request latency, histogram and JPEG
   times;
21. the dense shear-warp trainer at full width (``phase_dense_trainer``):
   ``train.shearwarp_trainer`` over a 256³ smooth truth with
   ``ShearWarpParams``' defaults (K = 256, 256² slope grids), 4 views,
   5 Adam steps ("post") and 2 ("pre"), the plain pipeline (batched
   products, no kernel); step time, Mrays/s, peak memory, one step under
   ``profiled`` (``utils.profiling.device_trace``, as every profiled
   step and frame); the TF gather's ``bincount`` backward against
   autograd's indexing in ``render_slope_grid_fused`` at full width,
   timed; card vs CPU on a 32³ problem;
22. ``models.VolumeScene`` at full width (``phase_scene``): a 512³
   smooth volume, 512² rays, the early exit 0.999: the target's render
   and 5 Adam steps on the estimate's MSE (the step time the median of
   steps 2-5), with K3's and K4's counts set to 0 before and read after
   and the plain marcher made to raise; K3 and
   K4 (with the exit rule) vs plain on a 64×64 window, K4 on every field
   of ``testing.FIELDS`` with the rays that exit counted; K4 with the exit
   on and off, timed; the 16³ test scene on the card vs the CPU;
23. the benchmark scripts (``phase_scripts``): ``bench_forward --quick``,
   ``probe_bwd_breakdown``, ``demo_inverse_render`` (store and
   ``--exact``) and ``demo_out_of_core`` cut to 512³, each ``python -m``
   in its own process with its wall time, each holding one call of every
   kernel it runs against the kernel's plain version; their launch counts
   and largest errors go into the kernels line;
24. ``entry()`` on the card (``phase_entry``) vs the plain march, and the
   phases' seconds through ``utils.profiling.StageTimers``;
25-29. the multi-device layer (M9) on logical shards of the one card
   (``[cuda:0] * 4``; the decomposition, the folds and each shard's
   kernel launch, not multi-card scaling): the sharded bricked orbit
   (``phase_sharded_orbit``: 2x2 and 4x1 meshes, the replicated store and
   slabs, early exit off and 0.999, against the one-device frames), the
   sharded store trainers (``phase_sharded_training``: views x rows on
   2x2, slabs on 2 and 4 brick shards, against the one-device step, then
   Adam steps), ``VolumeScene.render_sharded`` (``phase_sharded_exact``),
   ``render_cli --mesh`` and ``RenderService`` over a mesh
   (``phase_mesh_apps``), and two processes in one gloo group on the card
   (``phase_two_process``);
30. the exact gradient over a brick set (``phase_exact_set``): the
   mesh-sharded exact trainer over a 512³ smooth volume in 512 bricks of
   68³, 512² rays, 5 Adam steps on a 1x1 mesh and on a 2x2 mesh of
   logical shards (K3 and K4 once per shard and step; the 2x2 loss and
   gradients against the 1x1 ones), and ``VolumeScene.render`` over the
   same set with the early exit on; each K4 site (512 and 256 bricks)
   timed with its bound and held against the plain version on a 64x64
   window of its rays;
31. what finished the one-card port (``phase_finish``): K3 and K4 through
   their runtime-T instances at T = 1, 32 and 1024 against their plain
   versions on a 64x64 window of phase 13's view 0, the whole view timed
   at those T beside T = 256; then, with the counts set to 0 before and
   read after, 5 Adam steps of the exact trainer from a 32-entry TF, the
   1x2 and 2x2 walls of ``RenderService`` at 512x512 through
   ``render_wall`` against the sequential loop, 2x2 requests over HTTP
   through the wall and through the loop, and the bf16 store frame (K1)
   and dense frame (K5); every wall tile and served canvas bit-equal to
   the loop's, the bf16 launches bit-equal to plain and timed beside the
   f32 instances'; ``benchmarks/demo_wall`` at its defaults;
32. the trainers' update (``phase_adam``): ``train.update.step_optimizer``
   over a 512³ leaf and a (256, 4) TF through ``csrc/adam_update.cu`` (one
   launch a leaf, no fallback), each epilogue held to ``torch.optim.Adam``
   plus the old epilogue over 5 steps within ``testing.ADAM_TOL_ULPS``;
   the kernel timed on the 512³ leaf beside its bound (28 B a value),
   ``torch.optim.Adam``'s foreach step plus the old epilogue's passes (the
   path it replaced), torch's fused Adam with the epilogue in place (the
   ``library_ms``), and the plain version.  The trainers' runs on the card
   (dense, sharded store, exact set, exact and store trainers) and these
   checked steps count the kernel's launches from 0 and raise on a
   fallback (``adam_counted``); the ``kernels`` line sums those counts.

Prints every kernel's launch sites on the main paths (launches, time
per launch on the site's operands, bound, and launches × (time − bound),
the port's rule-2 ranking), then one JSON line describing the kernels
(with each kernel's bound:
the larger of its bytes over the HBM rate and its f32 operations over
their peak, from this run's work), then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from libre_tpu_torch.testing import EXACT_GRAD_TOL_MAX, compare, compare_grads

SMALL_TOL_MAX = 2e-3
URI = "mem://#512,512,512,32?pattern=gradient"
TRAIN_VIEWS = 4
TRAIN_STEPS = 5
SUBSET = 64  # K3 vs plain on a SUBSET x SUBSET window of the main-path view

# The least time an H100 SXM could take for a kernel's work: bytes over the
# HBM rate, f32 operations (outside the tensor cores) over their peak
# (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF_BYTES = 256 * 4 * 4
# f32 operations per sample, counted from the kernels' per-sample code
# (an add, multiply, divide, compare, min/max, floor, conversion or atomic
# add counts one, powf three; integer index arithmetic is not counted):
# K1 and K2 per fetched plane sample (post_sweep.cu, store_grid_bwd.cu
# with the TF gradient), K3 per composited sample by filter, for a uint8
# atlas (exact_march.cu).
K1_OPS_PER_SAMPLE = 97
K2_OPS_PER_SAMPLE = 173
# Of those, the TF gradient's: a run's bin test, 1 - wt, and the 8
# products and 8 adds into the run (tf_grad.cuh's Run.add; a flush is per
# run, not per sample, and not counted): what diff_tf=False does not do.
K2_TF_OPS_PER_SAMPLE = 18
K3_OPS_PER_SAMPLE = {"nearest": 69, "trilinear": 122}
# Of those, the casts of a uint8 atlas's taps to f32, which an f32 atlas
# does not do.
K3_CAST_OPS = {"nearest": 1, "trilinear": 8}
# K4 per sample of an f32 brick (exact_march_bwd.cu): K3's count without
# the 8 (1) conversions and its composite (10), plus the recompute's
# backward: the weight and prefix (8), the inversion (9), the opacity
# correction's slope and gate (9), the TF gradient (18, as K2's), the
# density gates and slope (17), the taps' weights, products and global
# atomics (44 trilinear, 1 nearest), T (2).
K4_OPS_PER_SAMPLE = {"nearest": 122, "trilinear": 211}
K4_TF_OPS_PER_SAMPLE = 18  # the TF gradient's share: not done with diff_tf=False
# K5 per composited sample (pre_sweep.cu): the early-exit test (2), the
# sample point (4) and box test (4), both axes' taps (24), the RGBA lerps
# (87: 7 four-channel lerps, each weight's 1 − w once), the opacity
# correction (6) and the composite (9).
K5_OPS_PER_SAMPLE = 136
# The Adam kernel per value (adam_update.cu): p, g, m and v read, p, m and v
# written; the lerp (3), the second moment (4), the denominator (3), the
# update (3) and the epilogue's compares (2).
ADAM_BYTES_PER_VALUE = 28
ADAM_OPS_PER_VALUE = 15
# The exact trainer's views: benchmarks/demo_inverse_render.py:34-37.
EXACT_EYES = ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3], [0.02, -0.12, 1.5], [-0.05, -0.02, 1.2])
EXACT_TRAIN_N = 512
EXACT_TRAIN_ORDER = (0, 1, 2, 3, 0)


# The gather probes P1-P17 (benchmarks/probe_*.py, ported as
# libre_tpu_torch/benchmarks on ops/gather.py), each as (bytes, f32
# operations) from its shapes: each input read once and each output written
# once, where a gather reads only the table entries its indices can reach
# (at most one per index); one add per gathered value in the probes that
# sum over a loop of LOOP = 512, three per two-tap lerp (P12).
PROBE_WORK = {
    "P1": (3 * 1024 * 4, 0),
    "P2": (3 * 1024 * 4, 0),
    "P3": (3 * 1024 * 4, 0),
    "P4": (3 * 1024 * 4, 0),
    "P5": (3 * 1024 * 4, 512 * 1024),
    "P6": ((8 * 1024 + 2 * 1024) * 4, 512 * 1024),
    "P7": (3 * 512 * 128 * 4, 0),
    "P8": (3 * 1024 * 4, 512 * 1024),
    "P9": ((2 * 8 * 128 + 128) * 4, 0),
    "P10 axis 1": (3 * 128 * 128 * 4, 0),
    "P10 axis 0": (3 * 128 * 128 * 4, 0),
    "P11": ((2 * 512 * 64 * 256 + 256) * 4, 0),
    "P12": ((512 * 64 * 256 + 4 * 256 + 512 * 4 * 64 * 256) * 4, 512 * 4 * 64 * 256 * 3),
    "P13": ((2 * 64 * 512 + 256) * 4, 0),
    "P14": ((32768 + 2 * 1024 * 128) * 4, 0),
    "P15": ((32768 + 3 * 1024 * 128) * 4, 0),
    "P16": (3 * 1024 * 4, 0),
    "P17": ((256 * 4 + 1024 * 128 + 1024 * 128 * 4) * 4, 0),
}


# The probes of the kernels redesigned after their port: probe_take.cu (P1,
# P9, P14, P15), probe_take_along.cu's loop sums (P5, P6, P8) and single
# gather (P2-P4, P7, P10, P16), and probe_tf_nearest.cu (P11, P13, P17).
# Phase 19 times them against the parent checkout's build when there is one.
PROBE_AB = ("P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9", "P10 axis 1", "P10 axis 0",
            "P11", "P13", "P14", "P15", "P16", "P17")


def bound(bytes_, ops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def free_device_memory():
    """Free what the deleted objects held on the card: the cycle collector
    first (a ``RenderEngine`` is freed only by it, so without it a deleted
    engine's 10 GB atlas may outlive the next engine's allocation), then
    the allocator's cached blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


ADAM_RUNS = []  # (main path, the Adam kernel's launches there), for the kernels line


@contextlib.contextmanager
def adam_counted(what, want):
    """A main path of the trainers' update: ``adam_update.launches`` and
    ``step_optimizer.fallbacks`` set to 0 before it, and after it raises
    unless the kernel launched ``want`` times (a leaf a step) with no
    fallback; the count goes into ``ADAM_RUNS``."""
    from libre_tpu_torch.ops.adam import adam_update
    from libre_tpu_torch.train.update import step_optimizer

    adam_update.launches = step_optimizer.fallbacks = 0
    yield
    got = (adam_update.launches, step_optimizer.fallbacks)
    if got != (want, 0):
        raise AssertionError(f"{what}: the Adam kernel launched {got[0]} times and the update "
                             f"fell back {got[1]} times, want {want} and none")
    ADAM_RUNS.append((what, want))


def cuda_ms(fn, reps, warmup=2):
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def profiled(what, fn, tags, card, unprofiled_ms, top=0):
    """Run ``fn`` (which must end by synchronising) once inside
    ``utils.profiling.device_trace`` (torch.profiler, a Chrome trace into
    a temporary directory) and print its host-clock time, its device time
    in kernels and in copies (memcpy, memset) with their counts, the
    device's idle share of ``unprofiled_ms`` (the same work's host-clock
    time without the profiler, whose own cost inflates its clock) and of
    the profiled clock, the kernels' time by the first of ``tags`` in each
    kernel's name ("other" for none), and with ``top`` the ``top`` device
    ops by time.  Annotated ranges, which span kernels, are left out.
    Raises if the trace holds no device time."""
    from torch.autograd import DeviceType

    from libre_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as log_dir, device_trace(log_dir) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, n_kernels, copy_ms, n_copies, ops = {}, 0, 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3
        ops.append((ms, e.count, e.key))
        if e.key.startswith(("Memcpy", "Memset")):
            copy_ms += ms
            n_copies += e.count
            continue
        tag = next((t for t in tags if t in e.key), "other")
        groups[tag] = groups.get(tag, 0.0) + ms
        n_kernels += e.count
    kernel_ms = sum(groups.values())
    busy_ms = kernel_ms + copy_ms
    print(
        f"{what} under torch.profiler: {wall_ms:.3f} ms host clock ({unprofiled_ms:.3f} ms "
        f"unprofiled); device {kernel_ms:.3f} ms in {n_kernels} kernels + {copy_ms:.3f} ms in "
        f"{n_copies} copies; idle share {1.0 - busy_ms / unprofiled_ms:.3f} of the unprofiled "
        f"time ({1.0 - busy_ms / wall_ms:.3f} of the profiled clock); kernels: "
        + "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(groups.items(), key=lambda kv: -kv[1]))
        + f" {card}"
    )
    for ms, n, key in sorted(ops, reverse=True)[:top]:
        print(f"  {ms:.3f} ms in {n} x {key[:90]}")
    if busy_ms <= 0.0:
        raise AssertionError(f"{what}: the trace holds no device time")


def rate(what, ms, samples, bound_ms, card):
    """Print a kernel time with its samples per second and its share of
    the bound."""
    print(
        f"  {what}: {ms:.4f} ms, {samples / (ms * 1e-3) / 1e9:.3f} G samples/s; bound "
        f"{bound_ms:.4f} ms, kernel at {bound_ms / ms:.4f} of it {card}"
    )


class Recorder:
    """Records the operands of every launch of the named kernels while it
    is entered, by wrapping ``_kernels.launch`` (the wrappers' launch
    counts are untouched); ``calls`` holds (name, args) in order."""

    def __init__(self, *names):
        self.names, self.calls = names, []

    def __enter__(self):
        from libre_tpu_torch.ops import _kernels

        self.real = _kernels.launch

        def launch(name, *args):
            if name in self.names:
                self.calls.append((name, args))
            return self.real(name, *args)

        _kernels.launch = launch
        return self

    def __exit__(self, *exc):
        from libre_tpu_torch.ops import _kernels

        _kernels.launch = self.real


def k1_operands(args):
    """(store, tf, tables, clip, keyword arguments) of a recorded
    ``post_sweep`` launch, and its (out, t_out)."""
    from libre_tpu_torch.ops import shearwarp_bricked as swb

    (store, tf, a0, a1, wa, dl, act, view, corr, clip, rgb_in, t_in, out, t_out,
     _k, _nc, _nb, _v, _u, n_clip, wb0, wb1, wc0, wc1, _sb, _sc, early_exit, bf16) = args
    tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=view, corr=corr,
                             rgb_in=rgb_in, t_in=t_in)
    kw = dict(n_clip=n_clip, wb=(wb0, wb1), wc=(wc0, wc1), early_exit=early_exit,
              compute_dtype="bfloat16" if bf16 else "float32")
    return (store, tf, tables, clip, kw), (out, t_out)


def k1_work(store, tf, tables, clip, kw):
    """K1's work on these operands, from the plain sweep: a dict of its
    output (``want``, ``t_want``), the per-ray ``samples`` fetched, the
    (K,) ``planes`` and (TV, TU, K) tiles' ``fetches`` at which some ray
    fetches, the number of store voxels ``touched`` under the taps, and
    K1's ``bound``: those voxels read once, the per-ray operands and
    outputs, the TF and the plane tables; the fetched samples' operations."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb

    dev = store.device
    v_size, u_size = tables.corr.shape
    k_planes = tables.a0.shape[0]
    rows, cols = swb.SWEEP_TILE
    samples = torch.zeros((v_size, u_size), dtype=torch.int64, device=dev)
    planes = torch.zeros(k_planes, dtype=torch.bool, device=dev)
    touched = torch.zeros(store.shape, dtype=torch.bool, device=dev)
    fetches = torch.zeros((-(-v_size // rows), -(-u_size // cols), k_planes),
                          dtype=torch.bool, device=dev)
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, samples=samples,
                                            planes=planes, touched=touched, fetches=fetches,
                                            **kw)
    n_touched = int(touched.sum())
    return dict(
        want=want, t_want=t_want, samples=samples, planes=planes, fetches=fetches,
        touched=n_touched,
        bound=bound(bytes_=n_touched * 4 + v_size * u_size * 11 * 4 + TF_BYTES + k_planes * 5 * 4,
                    ops=int(samples.sum()) * K1_OPS_PER_SAMPLE),
    )


def k3_counts(args):
    """Relaunch a recorded ``exact_march`` with fresh per-ray sample
    counts and per-brick use flags (not counted as a main-path launch):
    (out, samples, used)."""
    import torch

    from libre_tpu_torch.ops import _kernels

    args = list(args)
    carry, n_bricks = args[5], args[11]
    out = torch.empty_like(carry)
    samples = torch.zeros(carry.shape[0], dtype=torch.int32, device=carry.device)
    used = torch.zeros(n_bricks, dtype=torch.int32, device=carry.device)
    args[6:9] = out, samples, used
    _kernels.launch("exact_march", *args)
    return out, samples, used


def k3_bound_of(samples, used, slot_bytes, n_bricks, n_rays, filter_mode, f32_atlas,
                n_tf=256):
    """K3's bound: the bricks some ray samples (their atlas slots) read
    once, the boxes, slots, ray pack, carry in and out and the n_tf-entry
    TF; the composited samples' operations (an f32 atlas casts nothing)."""
    ops = K3_OPS_PER_SAMPLE[filter_mode] - (K3_CAST_OPS[filter_mode] if f32_atlas else 0)
    return bound(
        bytes_=int(used.sum()) * slot_bytes + n_bricks * (16 + 1) * 4
        + n_rays * (8 + 4 + 4) * 4 + n_tf * 16,
        ops=int(samples.sum()) * ops,
    )


def k4_bound_of(n_voxels, n_rays, samples, filter_mode, diff_tf, n_tf=256):
    """K4's bound: the f32 volume read and d_volume written once, the ray
    pack, out and g read, the n_tf-entry TF and (with the TF gradient)
    d_tf; every sample's operations."""
    ops = K4_OPS_PER_SAMPLE[filter_mode] - (0 if diff_tf else K4_TF_OPS_PER_SAMPLE)
    return bound(bytes_=2 * n_voxels * 4 + n_rays * 16 * 4 + (1 + diff_tf) * n_tf * 16,
                 ops=samples * ops)


def check_k3_counts(got, want, what, early_exit):
    """K3's per-ray sample counts and per-brick use flags against the
    plain march's: the flags equal; a count may differ only on a ray that
    one of the two ended by the early exit (the plain version folds
    chunks in closed form, so its alpha crosses the threshold a sample
    apart on some rays), and on at most one ray in 200 (the cap of
    tests/test_torch_cuda.py).  Returns the number of such rays."""
    (out, samples, used), (out_p, samples_p, used_p) = got, want
    if not bool((used == used_p).all()):
        raise AssertionError(f"{what}: K3's used bricks differ from the plain march's")
    moved = samples != samples_p
    ended = (out[:, 3] > early_exit) | (out_p[:, 3] > early_exit)
    if bool((moved & ~ended).any()):
        raise AssertionError(f"{what}: K3's sample counts differ from plain on rays "
                             f"the early exit did not end")
    flips = int(moved.sum())
    if flips > samples.shape[0] // 200:
        raise AssertionError(f"{what}: K3's sample counts differ from plain on {flips} "
                             f"of {samples.shape[0]} rays")
    print(f"  {what}: used bricks equal; sample counts equal but on {flips} rays "
          f"ended by the early exit")
    return flips


def orbit_cameras(n=8, width=512, height=512):
    from libre_tpu_torch.apps.render_cli import build_camera

    poses = []
    for az in np.linspace(-10.0, 10.0, n):
        a = np.deg2rad(az)
        eye = (1.5 * np.sin(a), 0.15, 1.5 * np.cos(a))
        poses.append(build_camera(width, height, eye, (0.0, 0.0, 0.0)))
    return poses


OOC_URI = "mem://#1024,1024,1024,64?pattern=gradient"
OOC_MB = 512  # the squeezed orbit's device budget: an atlas of 719 slots
INCORE_MB = 10240  # an atlas of every brick and a derived budget over the 4 GiB store
OOC_FINEST = 4  # min_lod: the finest level of the 1024^3 volume in 64^3 bricks


class UploadClock:
    """Times an atlas's uploads apart, by wrapping its instance methods:
    host stacking (``_stack``) and pinning (``_pinned``) on the host
    clock, the copy into the slots (``_copy``: host → device and the
    indexed write) by CUDA events on the atlas's stream.  ``take()``
    returns and resets the sums (after a synchronise)."""

    def __init__(self, atlas):
        import torch

        self.atlas = atlas
        self.real = (atlas._stack, atlas._pinned, atlas._copy)
        self.reset()

        def stack(bricks):
            t = time.perf_counter()
            out = self.real[0](bricks)
            self.stack_s += time.perf_counter() - t
            self.bricks += out.shape[0]
            self.bytes += out.nbytes
            return out

        def pinned(bricks):
            t = time.perf_counter()
            out = self.real[1](bricks)
            self.pin_s += time.perf_counter() - t
            return out

        def copy(slots, host):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(atlas.stream)
            self.real[2](slots, host)
            end.record(atlas.stream)
            self.events.append((start, end))
            self.slots.extend(int(x) for x in slots)

        atlas._stack, atlas._pinned, atlas._copy = stack, pinned, copy

    def reset(self):
        self.bricks, self.bytes, self.stack_s, self.pin_s = 0, 0, 0.0, 0.0
        self.events, self.slots = [], []

    def take(self):
        out = dict(bricks=self.bricks, bytes=self.bytes, stack_ms=self.stack_s * 1e3,
                   pin_ms=self.pin_s * 1e3,
                   copy_ms=sum(a.elapsed_time(b) for a, b in self.events), slots=self.slots)
        self.reset()
        return out

    def close(self):
        self.atlas._stack, self.atlas._pinned, self.atlas._copy = self.real


def phase_out_of_core(dev, card):
    """18. The out-of-core slab multipass and the upload pipeline on the
    reference's own out-of-core demo size (benchmarks/demo_out_of_core.py,
    OOC_RUN_r05.json): a 1024^3 uint8 volume in 64^3 bricks, rendered at
    its finest level (4096 bricks, a 4 GiB store).  ``render_cli`` at the
    default 3072 MB budget; an 8-pose orbit at 512 MB (two warm laps, a
    measured one) against the same orbit in core, bit for bit; the
    asynchronous ``render_bricked`` and ``render`` on cold engines; and
    ``upload_view`` behind a frame's kernels.  Bricks are generated once,
    by the CLI frame, and served from a memo to the later engines.
    Returns (K1 launch sites, K1 launches on its main paths, K1's max |d|
    against plain)."""
    import torch

    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.data import memory
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.utils.image import read_image

    load_plugins()
    t_phase = time.perf_counter()
    memo = {}
    real_get_data = memory.MemoryDataSource.get_data
    real_render_slabs = RenderEngine._render_slabs
    real_plain = swb.post_sweep_reference
    slab_frames, plain_calls = [], []

    def get_data(self, lod_node):
        key = (self.volume_info.voxels, lod_node.node_id.id)
        if key not in memo:
            memo[key] = real_get_data(self, lod_node)
        return memo[key]

    def render_slabs(self, render_nodes, render_level, fine_dims, *args):
        slab_frames.append((len(render_nodes), render_level, fine_dims, self.device_budget.budget))
        return real_render_slabs(self, render_nodes, render_level, fine_dims, *args)

    def plain(*args, **kwargs):
        plain_calls.append(1)
        return real_plain(*args, **kwargs)

    memory.MemoryDataSource.get_data = get_data
    RenderEngine._render_slabs = render_slabs
    swb.post_sweep_reference = plain
    try:
        # ---------------------------------------------- the CLI frame
        swb.post_sweep.launches = 0
        with tempfile.TemporaryDirectory() as out_dir, Recorder("post_sweep") as k1_cli:
            t0 = time.perf_counter()
            rc = render_cli.main([
                "--volume", OOC_URI, "--width", "512", "--height", "512",
                "--min-lod", str(OOC_FINEST), "--output-dir", out_dir,
            ])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            png = read_image(os.path.join(out_dir, "frame_000000.png"))
        cli_launches = swb.post_sweep.launches
        # ------------------------------------------ end of the CLI frame
        if rc != 0 or png.shape[:2] != (512, 512) or png.max() == 0:
            raise AssertionError(f"render_cli at 1024^3: rc {rc}, {png.shape}, max {png.max()}")
        (n_bricks, level, dims, budget), = slab_frames
        if plain_calls:
            raise AssertionError("the out-of-core CLI frame ran the plain sweep")
        n_passes = len(k1_cli.calls)
        if n_passes < 2 or cli_launches != n_passes:
            raise AssertionError(f"render_cli at 1024^3: {n_passes} passes, {cli_launches} K1 "
                                 f"launches")
        print(f"out-of-core render_cli 512x512 frame at the default 3072 MB: render level "
              f"{level}, {n_bricks} bricks, store {dims} = {int(np.prod(dims)) * 4} B over a "
              f"{budget} B derived budget, {n_passes} slab passes, {cli_launches} K1 launches; "
              f"{cli_s:.3f} s incl. generating the bricks {card}")
        cli_ops, (cli_out, cli_t) = k1_operands(k1_cli.calls[0][1])
        cli_work = k1_work(*cli_ops)
        torch.cuda.synchronize()
        if not (torch.equal(cli_out, cli_work["want"]) and torch.equal(cli_t, cli_work["t_want"])):
            raise AssertionError("render_cli at 1024^3, pass 1: K1 is not bit-equal to plain")
        cli_args = k1_cli.calls[0][1]
        cli_ms = cuda_ms(lambda: _kernels.launch("post_sweep", *cli_args), reps=10)
        cli_bound = cli_work["bound"]
        print(f"  K1 on pass 1's operands (slab {tuple(cli_ops[0].shape)}, "
              f"{cli_ops[2].a0.shape[0]} planes): {cli_ms:.4f} ms, bit-equal to plain; bound "
              f"{cli_bound[0]:.4f} ms ({cli_bound[1]}) {card}")
        del k1_cli, cli_ops, cli_out, cli_t, cli_work, cli_args
        free_device_memory()
        print(f"phase 18, CLI frame: {time.perf_counter() - t_phase:.1f} s")

        # ------------------------------------------- the out-of-core orbit
        poses = orbit_cameras()
        kw = dict(screen_space_error=1.0, min_lod=OOC_FINEST)
        ooc = RenderEngine(DataSource(OOC_URI), max_gpu_cache_mb=OOC_MB, device=dev)
        clock = UploadClock(ooc.atlas)
        passes = []
        real_nodes = ooc._slab_nodes

        def slab_nodes(*args):
            passes.append(real_nodes(*args))
            return passes[-1]

        ooc._slab_nodes = slab_nodes
        for _lap in range(2):
            for camera, frustum in poses:
                ooc.render_bricked(camera, frustum, **kw)
        torch.cuda.synchronize()
        clock.take()
        rows, ooc_frames = [], []
        evictions = ooc.texture_cache.statistics.evictions
        swb.post_sweep.launches = 0
        plain_calls.clear()
        for i, (camera, frustum) in enumerate(poses):
            passes.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            at_start = torch.cuda.memory_allocated(dev)
            before = swb.post_sweep.launches
            t0 = time.perf_counter()
            img, stats = ooc.render_bricked(camera, frustum, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            up = clock.take()
            ev = ooc.texture_cache.statistics.evictions
            rows.append(dict(ms=ms, passes=stats.n_passes, nonempty=sum(1 for p in passes if p),
                             launches=swb.post_sweep.launches - before, evicted=ev - evictions,
                             peak=torch.cuda.max_memory_allocated(dev), at_start=at_start, **up))
            evictions = ev
            ooc_frames.append(img)
        orbit_launches = swb.post_sweep.launches
        # ------------------------------------- end of the out-of-core orbit
        if plain_calls:
            raise AssertionError(f"the out-of-core orbit ran the plain sweep {len(plain_calls)} times")
        for i, r in enumerate(rows):
            if r["passes"] < 2 or r["evicted"] <= 0 or r["launches"] != r["nonempty"]:
                raise AssertionError(f"out-of-core frame {i}: {r['passes']} passes, {r['evicted']} "
                                     f"evictions, {r['launches']} K1 launches for {r['nonempty']} "
                                     f"passes with bricks")
            refilled = len(r["slots"]) - len(set(r["slots"]))
            print(f"  out-of-core frame {i}: {r['ms']:.3f} ms, {r['passes']} passes "
                  f"({r['nonempty']} with bricks, as many K1 launches), {r['evicted']} evictions, "
                  f"{r['bricks']} bricks = {r['bytes']} B uploaded ({refilled} slot refills within "
                  f"the frame): stack {r['stack_ms']:.3f} ms, pin {r['pin_ms']:.3f} ms (host), copy "
                  f"{r['copy_ms']:.3f} ms (device); peak allocated {r['peak']} B, "
                  f"{r['peak'] - r['at_start']} B above the frame's start {card}")
        med = lambda xs: float(np.median(xs))  # noqa: E731
        ooc_ms = [r["ms"] for r in rows]
        print(f"out-of-core orbit at {OOC_MB} MB ({ooc.atlas.n_slots}-slot atlas, "
              f"{ooc.device_budget.budget} B derived budget): frame median {med(ooc_ms):.3f} ms, "
              f"min {min(ooc_ms):.3f} ms; per frame (medians) {med([r['passes'] for r in rows])} "
              f"passes, {med([r['bricks'] for r in rows])} bricks, {med([r['bytes'] for r in rows])} "
              f"B uploaded; host stacking {med([r['stack_ms'] for r in rows]):.3f} ms, pinning "
              f"{med([r['pin_ms'] for r in rows]):.3f} ms; copies {med([r['copy_ms'] for r in rows]):.3f} "
              f"ms of device time on the frame's stream, serialised with the kernels (0 ms "
              f"overlapped); peak allocated above a frame's start "
              f"{max(r['peak'] - r['at_start'] for r in rows)} B against the {OOC_MB} MB budget "
              f"{card}")
        print(f"phase 18, out-of-core orbit: {time.perf_counter() - t_phase:.1f} s")

        # K1 on every pass of the last frame, bit-equal to plain and timed.
        camera, frustum = poses[-1]
        with Recorder("post_sweep") as k1_ooc:
            last, _ = ooc.render_bricked(camera, frustum, **kw)
        torch.cuda.synchronize()
        if not torch.equal(last, ooc_frames[-1]):
            raise AssertionError("the out-of-core frame is not reproducible")
        # The same frame while a side stream is current: the engine runs it
        # on the atlas's stream, and the side stream may read it at once.
        side = torch.cuda.Stream(dev)
        with torch.cuda.stream(side):
            side_img, side_stats = ooc.render_bricked(camera, frustum, **kw)
            side_img = side_img.clone()
        torch.cuda.synchronize()
        if side_stats.n_passes < 2 or not torch.equal(side_img, ooc_frames[-1]):
            raise AssertionError("the out-of-core frame under a side stream is not the "
                                 "default-stream frame bit for bit")
        print(f"out-of-core frame of the last pose under a side stream: {side_stats.n_passes} "
              f"passes, bit-equal to the default-stream frame")
        del side_img
        pass_ms, pass_bounds, pass_by = [], [], []
        for _name, args in k1_ooc.calls:
            ops, (out, t_out) = k1_operands(args)
            work = k1_work(*ops)
            torch.cuda.synchronize()
            if not (torch.equal(out, work["want"]) and torch.equal(t_out, work["t_want"])):
                raise AssertionError("an out-of-core pass: K1 is not bit-equal to plain")
            pass_ms.append(cuda_ms(lambda: _kernels.launch("post_sweep", *args), reps=10))
            pass_bounds.append(work["bound"][0])
            pass_by.append(work["bound"][1])
            del ops, out, t_out, work
        print(f"K1 on the {len(pass_ms)} passes of the last out-of-core frame, each bit-equal to "
              f"plain: {sum(pass_ms):.4f} ms in all, per pass mean {med(pass_ms):.4f} ms "
              f"(min {min(pass_ms):.4f}, max {max(pass_ms):.4f}); bound per pass mean "
              f"{float(np.mean(pass_bounds)):.4f} ms, {sum(pass_bounds):.4f} ms in all {card}")
        del k1_ooc

        unprofiled = med(ooc_ms)

        def ooc_frame():
            ooc.render_bricked(camera, frustum, **kw)
            torch.cuda.synchronize()

        profiled("one out-of-core frame", ooc_frame,
                 ("post_sweep_kernel", "index", "elementwise", "reduce", "cat", "copy"), card,
                 unprofiled)

        # upload_view for the next pose behind the current frame's kernels.
        t0 = time.perf_counter()
        ooc.render_bricked(poses[0][0], poses[0][1], **kw)
        t1 = time.perf_counter()
        clock.reset()
        n_up = ooc.upload_view(poses[1][1], 512, **kw)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        up = clock.take()
        print(f"upload_view of pose 1 after pose 0's frame was enqueued: {n_up} bricks, "
              f"{(t2 - t1) * 1e3:.3f} ms host (select, stack {up['stack_ms']:.3f} ms, pin "
              f"{up['pin_ms']:.3f} ms), frame + upload_view {(t3 - t0) * 1e3:.3f} ms to the "
              f"synchronise; upload_view's copies {up['copy_ms']:.3f} ms device {card}")
        clock.close()
        del ooc, clock, last
        free_device_memory()

        # ------------------------------------------------ the in-core orbit
        incore = RenderEngine(DataSource(OOC_URI), max_gpu_cache_mb=INCORE_MB, device=dev)
        slab_frames.clear()
        for camera, frustum in poses:
            incore.render_bricked(camera, frustum, **kw)
        torch.cuda.synchronize()
        incore_ms = []
        for i, (camera, frustum) in enumerate(poses):
            t0 = time.perf_counter()
            img, stats = incore.render_bricked(camera, frustum, **kw)
            torch.cuda.synchronize()
            incore_ms.append((time.perf_counter() - t0) * 1e3)
            if stats.n_passes != 1 or not torch.equal(img, ooc_frames[i]):
                raise AssertionError(f"pose {i}: the out-of-core frame is not the in-core frame "
                                     f"bit for bit ({stats.n_passes} in-core passes)")
        if slab_frames:
            raise AssertionError("the in-core orbit went out of core")
        with Recorder("post_sweep") as k1_in:
            incore.render_bricked(poses[-1][0], poses[-1][1], **kw)
        (_name, in_args), = k1_in.calls
        in_ms = cuda_ms(lambda: _kernels.launch("post_sweep", *in_args), reps=10)
        print(f"K1 in core on the last pose (one sweep of {in_args[14]} planes over the "
              f"{tuple(in_args[0].shape)} store): {in_ms:.4f} ms, against {sum(pass_ms):.4f} ms for "
              f"the out-of-core frame's {len(pass_ms)} passes {card}")
        del k1_in, in_args
        print(f"in-core orbit at {INCORE_MB} MB: frame median {med(incore_ms):.3f} ms, min "
              f"{min(incore_ms):.3f} ms; every out-of-core frame bit-equal to its in-core frame; "
              f"ooc_vs_incore {med(incore_ms) / med(ooc_ms):.4f} (in-core / out-of-core frame "
              f"median) {card}")
        sync_bricked = ooc_frames[0]
        sync_exact = incore.render(poses[0][0], poses[0][1], **kw)[0]
        del incore, ooc_frames
        free_device_memory()
        print(f"phase 18, in-core orbit: {time.perf_counter() - t_phase:.1f} s")

        # ------------------------------------------------------ async frames
        camera, frustum = poses[0]
        # The last run renders while a side stream is current, its image
        # cloned on that stream.
        for method, want, stream in (("render_bricked", sync_bricked, None),
                                     ("render", sync_exact, None),
                                     ("render_bricked", sync_bricked, torch.cuda.Stream(dev))):
            cold = RenderEngine(DataSource(OOC_URI), max_gpu_cache_mb=INCORE_MB, device=dev)
            futures = []
            t0 = time.perf_counter()
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                for frames in range(1, 51):
                    out = getattr(cold, method)(camera, frustum, synchronous=False, **kw)
                    img = out[0].clone() if stream is not None else out[0]
                    stats = out[1]
                    futures += stats.pending_uploads
                    if stats.rendering_done:
                        break
                else:
                    raise AssertionError(f"async {method} not done after 50 frames")
            torch.cuda.synchronize()
            async_s = time.perf_counter() - t0
            for f in futures:
                f.result()
            if frames < 2 or not torch.equal(img, want):
                raise AssertionError(f"async {method}: {frames} frames; the last is not the "
                                     f"synchronous frame bit for bit")
            under = " under a side stream" if stream is not None else ""
            print(f"async {method}{under} on a cold engine: done after {frames} frames, "
                  f"{async_s:.3f} s ({len(futures)} upload batches); the last frame bit-equal to "
                  f"the synchronous default-stream one {card}")
            del cold, out, img, stats, futures
            free_device_memory()
    finally:
        memory.MemoryDataSource.get_data = real_get_data
        RenderEngine._render_slabs = real_render_slabs
        swb.post_sweep_reference = real_plain
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    sites = [
        ("K1", "render_bricked out of core, render_cli frame (1024^3, 3072 MB, pass 1)",
         cli_launches, cli_ms, cli_bound),
        ("K1", f"render_bricked out of core, orbit (1024^3, {OOC_MB} MB, per pass)",
         orbit_launches, med(pass_ms),
         (float(np.mean(pass_bounds)), max(set(pass_by), key=pass_by.count))),
    ]
    return sites, cli_launches + orbit_launches, 0.0


def phase_probes(dev, card):
    """19. The gather probes P1-P17 through the port's own entry points
    (``python -m libre_tpu_torch.benchmarks.<module>``'s ``main``) at
    their full shapes: each probe's kernel bit-equal to its plain version
    and its library call (``_probe.run`` raises otherwise), timed in a
    CUDA graph and from Python, with the plain version and the library
    call.  The four gather kernels' counts are set to 0 just before and
    read just after; each must have launched, as often as its probes say.
    Then the kernel instances no probe reaches, each once, bit-equal to its
    plain version: the nearest lookup's scalar instance (a C = 3 table;
    densities 4 B past an aligned start), the loop sum too large to stage
    (either axis), and the NaN fill for a table with no entry along the
    axis (where the plain version raises).  Then an
    empty kernel timed in a CUDA graph as the probes are, the launch floor
    printed beside each probe, and the probes of the three
    redesigned kernels (``PROBE_AB``: ``probe_take.cu``,
    ``probe_take_along.cu``'s loop sums and single gather,
    ``probe_tf_nearest.cu``) timed against the parent checkout's build where
    one is unpacked under ``_archive/base`` (``_probe.against_parent``,
    bound as ``sweep_ab.py`` binds it).
    Returns the probes' entries of the ``kernels`` line."""
    import importlib
    from pathlib import Path

    import torch

    from libre_tpu_torch.benchmarks import MODULES
    from libre_tpu_torch.benchmarks import _probe
    from libre_tpu_torch.ops import gather

    t_phase = time.perf_counter()
    for wrapper in gather.KERNELS.values():
        wrapper.launches = 0
    results = []
    for name in MODULES:
        results += importlib.import_module(f"libre_tpu_torch.benchmarks.{name}").main(dev)
    counts = {kernel: wrapper.launches for kernel, wrapper in gather.KERNELS.items()}
    for kernel, n in counts.items():
        per_probe = sum(r["launches"] for r in results if r["kernel"] == kernel)
        if n == 0 or n != per_probe:
            raise AssertionError(f"{kernel}: {n} launches, its probes counted {per_probe}")
    if [r["probe"] for r in results] != list(PROBE_WORK):
        raise AssertionError(f"probes {[r['probe'] for r in results]} vs {list(PROBE_WORK)}")
    g = torch.Generator(device=dev).manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    d = torch.rand(4097, generator=g, device=dev) * 1.5 - 0.25
    wide = torch.randn(8, 13000, generator=g, device=dev)
    tall = torch.randn(400, 64, generator=g, device=dev)
    unreached = [
        ("nearest, a (256, 3) table", gather.tf_nearest,
         (d, torch.rand(256, 3, generator=g, device=dev)), dict(scale=256.0)),
        ("nearest, densities 4 B past an aligned start", gather.tf_nearest,
         (d[1:], torch.rand(256, generator=g, device=dev)), dict(scale=256.0, outside="zero")),
        ("loop sum of 3 over an (8, 13000) table along axis 1", gather.take_along,
         (wide, ints(-20000, 20000, (8, 300)), 1), dict(loop=3, mod=13000)),
        ("loop sum of 5 over a (400, 64) table along axis 0", gather.take_along,
         (tall, ints(-1000, 1000, (50, 64)), 0), dict(loop=5, mod=400)),
        ("a gather over an (8, 0) table (the NaN fill)", gather.take_along,
         (wide.new_empty(8, 0), ints(0, 300, (8, 300)), 1), {}),
    ]
    for label, wrapper, args, kw in unreached:
        before = wrapper.launches
        got = wrapper(*args, **kw)
        if args[0].numel():
            ok = torch.equal(got, wrapper.reference(*args, **kw))
        else:  # no entry to read: every output NaN (the plain version raises)
            ok = bool(got.isnan().all())
        torch.cuda.synchronize(dev)
        if wrapper.launches != before + 1 or not ok:
            raise AssertionError(f"{label}: {wrapper.launches - before} launches, "
                                 f"{'bit-equal' if ok else 'differs from plain'}")
        print(f"  {label}: one launch, {'bit-equal to plain' if args[0].numel() else 'all NaN'} "
              f"({got.numel()} values)")
    floor = _probe.launch_floor_ms()
    print(f"gather probes: us per call in a CUDA graph (from Python), bound, kernel / library; "
          f"launch floor (an empty kernel in a CUDA graph) {floor * 1e3:.3f} us {card}")
    entries, slower = [], []
    for r in results:
        b_ms, b_by = bound(*PROBE_WORK[r["probe"]])
        lib = r["library_ms"]
        vs_lib = f"{r['ms'] / lib:.3f}" if lib is not None else "no library call"
        print(f"  {r['probe']} {r['kernel']}: {r['ms'] * 1e3:.3f} ({r['ms_call'] * 1e3:.3f}) us; "
              f"plain {r['plain_ms'] * 1e3:.3f} us; library {r['library']}"
              + (f" {lib * 1e3:.3f} ({r['library_call_ms'] * 1e3:.3f}) us" if lib is not None
                 else "")
              + f"; bound {b_ms * 1e3:.5f} us ({b_by}), kernel at {b_ms / r['ms']:.4f} of it; "
              f"{r['ms'] / floor:.2f}x the launch floor; kernel / library {vs_lib}; "
              f"{r['launches']} launches")
        if lib is not None and r["ms"] > lib:
            slower.append((r["ms"] / lib, r["probe"], r["kernel"]))
        entries.append({
            "name": r["kernel"],
            "probe": r["probe"],
            "route": "cuda",
            "source": f"libre_tpu_torch/csrc/{r['kernel']}.cu",
            "replaces": r["replaces"],
            "launches": r["launches"],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": lib,
        })
    print("  launches: " + "; ".join(f"{k} {n}" for k, n in counts.items()))
    print("  kernels slower than their library call (rule 2's order), kernel / library: "
          + ("; ".join(f"{p} {k} {x:.3f}" for x, p, k in sorted(slower, reverse=True))
             or "none"))
    parent = Path(__file__).resolve().parent / "_archive" / "base"
    if (parent / "libre_tpu_torch" / "csrc" / "probe_take.cu").exists():
        probes = [p for name in MODULES
                  for p in importlib.import_module(f"libre_tpu_torch.benchmarks.{name}").PROBES
                  if p.id in PROBE_AB]
        ab = _probe.against_parent(
            probes, parent, ("probe_take", "probe_take_along", "probe_tf_nearest"), dev)
        print(f"  against the parent's build ({parent}), us in a CUDA graph, least-most of "
              f"each build's runs, bit-equal {card}:")
        for line in _probe.against_parent_lines(ab, floor):
            print(line)
    else:
        print("  no parent checkout under _archive/base: the redesigned probes are not timed "
              "against the parent")
    print(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return entries


SERVE_SSE = 1.0  # phase 20's orbit: all 4096 finest bricks, one 512^3 store, as in phase 4
SERVE_ASYNC = {"synchronous": False, "max_lod": 2}  # a set no earlier step uploaded


def brick_bins(brick, overlap, lo, hi):
    """256 bins of a padded brick's interior by numpy, in the reference's
    order of rounding: the f64 normalisation cast to f32, times 256 in
    f32, truncated, clipped to [0, 255]."""
    ox, oy, oz = overlap
    core = brick[oz : brick.shape[0] - oz or None, oy : brick.shape[1] - oy or None,
                 ox : brick.shape[2] - ox or None]
    norm = ((core.astype(np.float64) - lo) / (hi - lo)).astype(np.float32)
    idx = np.clip((norm * np.float32(256)).astype(np.int32), 0, 255)
    return np.bincount(idx.ravel(), minlength=256).astype(np.int64), core.size


def phase_serve(dev, card, uri=URI, size=512):
    """20. The interactive service on the card: ``RenderService`` on the
    512^3 volume at 512x512 with the default 3072 MB, on 127.0.0.1, driven
    over HTTP with urllib: the 8-pose orbit as ``PUT /camera``, each
    followed by ``POST /image-jpeg`` and ``GET /histogram``; a ``PUT
    /colormap`` with the store cache untouched and one frame; ``PUT /params
    {"renderer": "exact"}`` and one frame (K3); the 2x2 layout and one
    frame (4 bricked views); an asynchronous frame of a set not yet
    uploaded (``max_lod`` 2), converged; ``GET /statistics`` and ``POST
    /exit``.  K1's and K3's counts are set to 0 just before and read just
    after.  Then each served frame (the array before JPEG encoding) is
    held bit-equal to the engine's own frame at the same camera and state,
    the async frame to the synchronous one, and each histogram's bins to
    numpy's over the frame's bricks, their sum to bricks x 32^3.  Returns
    (K1 launches, K3 launches, the 2x2 request's latency in ms)."""
    import urllib.request

    import torch

    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.utils import image

    t_phase = time.perf_counter()
    svc = RenderService(uri, width=size, height=size, host="127.0.0.1", port=0, device=dev)
    engine = svc.engine
    served, hist_calls, jpeg_ms = [], [], []
    real_frame, real_hist, real_jpeg = svc.render_frame, engine.accumulate_histogram, image.encode_jpeg
    real_select, real_view = engine.select, engine.render_bricked
    # Host ms of each call, for the split of an orbit request (one call of
    # each per orbit request): render_frame, its engine frame, the frame's
    # LOD selection.
    split = {"render_frame": [], "render_bricked": [], "select": []}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    def render_frame(progressive=False):
        t0 = time.perf_counter()
        canvas = real_frame(progressive)
        split["render_frame"].append((time.perf_counter() - t0) * 1e3)
        served.append(dict(
            canvas=canvas, mv=svc.frame_data.camera_settings.get_modelview_matrix().copy(),
            color_map=np.array(svc.frame_data.render_settings.color_map),
            params=dict(svc.server.params), layout=svc.layout, hist=svc._histogram,
            sets=[]))
        return canvas

    def accumulate_histogram(nodes, *args):
        t0 = time.perf_counter()
        out = real_hist(nodes, *args)
        hist_calls.append(((time.perf_counter() - t0) * 1e3, list(nodes)))
        return out

    def encode_jpeg(img, *args, **kwargs):
        t0 = time.perf_counter()
        out = real_jpeg(img, *args, **kwargs)
        jpeg_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    svc.render_frame, engine.accumulate_histogram, image.encode_jpeg = (
        render_frame, accumulate_histogram, encode_jpeg)
    engine.select = timed("select", real_select)
    engine.render_bricked = timed("render_bricked", real_view)
    svc.server.start()
    host, port = svc.server.address
    base = f"http://{host}:{port}"

    def call(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read()
            return json.loads(raw) if "json" in resp.headers.get("Content-Type", "") else raw

    latency, hists, steps = [], [], []

    def frame(step):
        n_hist = len(hist_calls)
        t0 = time.perf_counter()
        jpeg = call("/image-jpeg", "POST", {})
        latency.append((time.perf_counter() - t0) * 1e3)
        if jpeg[:2] != b"\xff\xd8":
            raise AssertionError(f"serve {step}: /image-jpeg gave no JPEG")
        hists.append(call("/histogram"))
        served[-1]["sets"] = [nodes for _ms, nodes in hist_calls[n_hist:]]
        steps.append(step)

    try:
        call("/params", "PUT", {"synchronous": True, "sse": SERVE_SSE})
        swb.post_sweep.launches = 0
        exact.march_exact.launches = 0
        for i, (_camera, frustum) in enumerate(orbit_cameras(width=size, height=size)):
            call("/camera", "PUT", {"modelview": frustum.mv.tolist()})
            frame(f"orbit {i}")
        keys = list(engine._store_cache)
        cm = np.roll(np.asarray(svc.frame_data.render_settings.color_map), 32, axis=0)
        call("/colormap", "PUT", {"rgba": cm.tolist()})
        frame("colormap")
        if list(engine._store_cache) != keys:
            raise AssertionError("a colormap edit touched the store cache")
        call("/params", "PUT", {"renderer": "exact"})
        frame("exact")
        call("/params", "PUT", {"renderer": "bricked"})
        if call("/layout", "PUT", {"name": "2x2"})["layout"] != "2x2":
            raise AssertionError("PUT /layout 2x2 refused")
        frame("2x2")
        call("/layout", "PUT", {"name": "single"})
        call("/params", "PUT", SERVE_ASYNC)
        renders = []
        real_bricked = engine.render_bricked

        def render_bricked(*args, **kwargs):
            out = real_bricked(*args, **kwargs)
            renders.append((kwargs.get("synchronous"), out[1].rendering_done,
                            out[1].n_render_available))
            return out

        engine.render_bricked = render_bricked
        frame("async")
        engine.render_bricked = real_bricked
        stats = call("/statistics")
        if call("/exit", "POST", {}) != {"ok": True}:
            raise AssertionError("POST /exit")
        k1, k3 = swb.post_sweep.launches, exact.march_exact.launches
        # --------------------------------------------- end of the served path
        for _ in range(100):
            if not svc._running:
                break
            time.sleep(0.05)
    finally:
        svc.server.stop()
        svc.render_frame, engine.accumulate_histogram, image.encode_jpeg = (
            real_frame, real_hist, real_jpeg)
        engine.select, engine.render_bricked = real_select, real_view
    if svc._running:
        raise AssertionError("POST /exit did not stop the service")
    for name in ("data_cache", "texture_cache"):
        got = {k: type(v).__name__ for k, v in stats[name].items()}
        if got != {k: "int" for k in ("hits", "misses", "objects", "used_bytes", "max_bytes")}:
            raise AssertionError(f"/statistics {name}: {got}")
    if not isinstance(stats["frames_rendered"], int):
        raise AssertionError("/statistics frames_rendered")
    # K1 once per bricked view: 8 orbit frames, the colormap frame, the 2x2's
    # four views and each asynchronous render that had bricks to draw.
    want_k1 = 8 + 1 + 4 + sum(1 for _s, _d, n in renders if n > 0)
    if len(served) != len(steps) or k1 != want_k1 or k3 != 1:
        raise AssertionError(f"serve: {len(served)} frames for {len(steps)} requests, K1 {k1} "
                             f"launches ({want_k1} expected), K3 {k3} (1 expected)")
    if not renders or any(sync is not False for sync, _d, _n in renders) or not renders[-1][1]:
        raise AssertionError(f"the async frame's renders {renders}: not asynchronous or not done")
    print(f"serve: {len(steps)} frames over HTTP ({', '.join(steps)}), K1 {k1} launches, K3 {k3}; "
          f"the async frame: {len(renders)} renders (done, bricks drawn): "
          f"{[(d, n) for _s, d, n in renders]} {card}")

    # Each served frame against the engine's own frame, its histogram
    # against numpy over its bricks.
    lo, hi = engine.data_source_range
    overlap = engine.info.overlap
    brick_voxels = int(np.prod(engine.info.block_size))
    bins_of = {}
    for step, rec, hist in zip(steps, served, hists):
        svc.frame_data.camera_settings.set_modelview_matrix(rec["mv"])
        svc.frame_data.render_settings.color_map = rec["color_map"]
        svc.server.params.clear()
        svc.server.params.update(rec["params"], synchronous=True)
        svc.layout = rec["layout"]
        engine.transfer_function = torch.as_tensor(rec["color_map"], device=dev)
        kw = svc.frame_keywords()
        for dx, dy, vw, vh, az in svc._layout_views():
            camera, frustum = svc.view_camera(vw, vh, az)
            if rec["params"].get("renderer", "bricked") == "exact":
                img = engine.render(camera, frustum, **kw)[0]
            else:
                img = engine.render_bricked(camera, frustum, **kw)[0]
            if not np.array_equal(img.cpu().numpy(), rec["canvas"][dy : dy + vh, dx : dx + vw]):
                raise AssertionError(f"serve {step}: the served frame (view at {dx},{dy}) is not "
                                     f"the engine's frame bit for bit")
        if not rec["sets"] or hist != rec["hist"]:
            raise AssertionError(f"serve {step}: /histogram is not the frame's histogram")
        nodes = rec["sets"][-1] if step == "async" else rec["sets"][0]  # the converged / view 0
        want = np.zeros(256, np.int64)
        for n in nodes:
            if n.id not in bins_of:
                bins_of[n.id] = brick_bins(engine.data_cache.get(n.id).value, overlap, lo, hi)
            want += bins_of[n.id][0]
        voxels = sum(bins_of[n.id][1] for n in nodes)
        if (hist["bins"] != want.tolist() or sum(hist["bins"]) != voxels
                or voxels != len(nodes) * brick_voxels):
            raise AssertionError(f"serve {step}: histogram bins are not numpy's over its "
                                 f"{len(nodes)} bricks")
        if (hist["min"], hist["max"]) != (lo, hi):
            raise AssertionError(f"serve {step}: histogram range {hist['min'], hist['max']}")
    sizes = sorted({len(r["sets"][-1 if step == "async" else 0]) for step, r in zip(steps, served)})
    print(f"serve: every served frame bit-equal to the engine's direct frame (the async one to "
          f"the synchronous frame), every histogram's bins equal to numpy's over its bricks, "
          f"sum = bricks x {brick_voxels} (sets of {sizes} bricks)")
    med = lambda xs: float(np.median(xs))  # noqa: E731
    first_hist = hist_calls[0][0]
    steady_hist = [ms for ms, _ in hist_calls[1:8]]
    print(f"serve request latency (POST /image-jpeg, {size}x{size}): orbit request 1 {latency[0]:.3f} "
          f"ms, requests 2-8 median {med(latency[1:8]):.3f} ms, min {min(latency[1:8]):.3f} ms; "
          f"colormap {latency[8]:.3f} ms, exact {latency[9]:.3f} ms, 2x2 {latency[10]:.3f} ms, "
          f"async {latency[11]:.3f} ms {card}")
    orbit = {k: v[1:8] for k, v in split.items()}
    hist_2_8 = [ms for ms, _ in hist_calls[1:8]]
    parts = [np.asarray(latency[1:8]) - np.asarray(orbit["render_frame"]) - np.asarray(jpeg_ms[1:8]),
             np.asarray(orbit["render_frame"]) - np.asarray(orbit["render_bricked"]),
             np.asarray(orbit["render_bricked"]) - np.asarray(orbit["select"])
             - np.asarray(hist_2_8)]
    print(f"serve orbit requests 2-8, medians of the host split: select "
          f"{med(orbit['select']):.3f} ms, histogram {med(hist_2_8):.3f} ms, the rest of the "
          f"engine frame {med(parts[2]):.3f} ms, render_frame around it (camera, TF upload, "
          f"canvas copy) {med(parts[1]):.3f} ms, JPEG {med(jpeg_ms[1:8]):.3f} ms, HTTP and the "
          f"handler {med(parts[0]):.3f} ms {card}")
    print(f"serve histogram (host): first frame {first_hist:.3f} ms ({len(hist_calls[0][1])} "
          f"bricks), steady frames 2-8 median {med(steady_hist):.3f} ms, min "
          f"{min(steady_hist):.3f} ms; JPEG encoding median {med(jpeg_ms):.3f} ms, min "
          f"{min(jpeg_ms):.3f} ms {card}")
    del svc, engine, served
    free_device_memory()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return k1, k3, latency[10]


# ------------------------------------------------------------- phases 21-24
DENSE_TRAIN_N = 256  # phase 21: the truth's size, ShearWarpParams' defaults (K = 256, 256^2 grids)
DENSE_TRAIN_STEPS = 5
DENSE_PRE_STEPS = 2
SCENE_N = 512  # phase 22: the scene's volume, SCENE_RAYS^2 rays, the scene's default params
SCENE_RAYS = 512
SCENE_EXIT = 0.999  # its early exit (RenderParams' default)
SCENE_STEPS = 5  # Adam steps (lr SCENE_LR) on its MSE, timed as the trainers' steps
SCENE_LR = 1e-2
# Phase 23: the benchmark scripts, each in a process of its own, as
# (module, arguments); demo_out_of_core cut from 1024^3 to 512^3 (its
# full-size default runs by hand), its budgets 2048 MB in core (a 512^3
# store fits) and 96 MB (its default) out of core.
SCRIPT_RUNS = (
    ("bench_forward", ["--quick"]),
    ("probe_bwd_breakdown", []),
    ("demo_inverse_render", []),
    ("demo_inverse_render", ["--exact"]),
    ("demo_out_of_core", ["--vox", "512", "--incore-mb", "2048", "--ooc-mb", "96"]),
)
GMIN_GMAX = (np.float32([-0.5] * 3), np.float32([0.5] * 3))


def phase_dense_trainer(dev, card):
    """21. The dense shear-warp trainer at full width: a 256^3 smooth truth,
    ``ShearWarpParams``' defaults (K = 256 planes, 256^2 slope grids), 4
    views ("post"), 5 Adam steps (lr 3e-2) from a flat 0.5 volume and a
    grayscale TF; the loss must fall.  Step time (median of steps 2-5),
    Mrays/s, peak memory above the phase's start, one step under
    ``profiled`` with its top device ops; "pre" for 2 steps; the TF
    gather's backward by bincount against autograd's indexing in
    ``render_slope_grid_fused`` at full width, timed, gradients within
    ``DENSE_GRAD_TOL``; card vs CPU on a 32^3 / 32^2 problem, loss and one
    Adam step's leaves within 1e-4.  The trainer runs the plain pipeline
    (batched products): no kernel of the port."""
    import torch

    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.ops import transfer_function as tfm
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.ops.transfer_function import default_color_map, grayscale_ramp
    from libre_tpu_torch.testing import DENSE_GRAD_TOL, smooth_volume
    from libre_tpu_torch.train import ShearWarpProblem, make_shearwarp_train_step

    gmin, gmax = GMIN_GMAX
    params = RenderParams(data_source_range=(0.0, 1.0), filter_mode="trilinear")
    cams = [build_camera(512, 512, e, (0.0, 0.0, 0.0))[0] for e in EXACT_EYES]

    def problem(classification):
        return ShearWarpProblem.from_cameras(
            cams, gmin, gmax, params,
            sw.ShearWarpParams(classification=classification))

    def start(shape, device):
        leaves = {"volume": torch.full(shape, 0.5, device=device).requires_grad_(),
                  "tf": torch.from_numpy(grayscale_ramp()).to(device).requires_grad_()}
        return leaves, torch.optim.Adam([leaves["volume"], leaves["tf"]], lr=3e-2)

    truth = smooth_volume(DENSE_TRAIN_N, seed=7, device=dev)
    tf_true = torch.from_numpy(default_color_map()).to(dev)
    runs = {}
    for classification, n_steps in (("post", DENSE_TRAIN_STEPS), ("pre", DENSE_PRE_STEPS)):
        prob = problem(classification)
        with torch.no_grad():
            targets = prob.render_views(None, truth, tf_true)
        leaves, opt = start(truth.shape, dev)
        step = make_shearwarp_train_step(prob, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        losses, at = [], []
        t0 = time.perf_counter()
        with adam_counted(f"dense trainer ({classification})", 2 * n_steps):
            for _ in range(n_steps):
                losses.append(float(step(leaves, targets)))  # synchronises
                at.append(time.perf_counter())
        peak = torch.cuda.max_memory_allocated(dev) - base
        steps_ms = np.diff([t0] + at) * 1e3
        step_ms = float(np.median(steps_ms[1:]))
        n_rays = len(prob.plans) * prob.swp.inter_size[0] * prob.swp.inter_size[1]
        print(
            f"dense trainer ({classification}): {DENSE_TRAIN_N}^3, K = {prob.swp.n_planes}, "
            f"{len(prob.plans)} views of {prob.swp.inter_size} slope rays, {n_steps} Adam steps;"
            f" losses {losses}; step median of steps 2-{n_steps} {step_ms:.3f} ms (all steps "
            f"{', '.join(f'{x:.3f}' for x in steps_ms)} ms); fwd+bwd "
            f"{n_rays / (step_ms * 1e-3) / 1e6:.3f} Mrays/s; peak memory {peak} B above the "
            f"start {card}"
        )
        if not all(np.isfinite(losses)):
            raise AssertionError(f"dense trainer ({classification}): losses {losses}")
        for k, v in leaves.items():
            if float(v.detach().min()) < 0.0 or float(v.detach().max()) > 1.0:
                raise AssertionError(f"dense trainer ({classification}): {k} left [0, 1]")
        if classification == "post":
            if not losses[-1] < losses[0]:
                raise AssertionError(f"dense trainer did not lower its loss: {losses}")
            profiled("one dense training step (post, 4 views)",
                     lambda: float(step(leaves, targets)), ("gather", "Histogram", "gemm"),
                     card, step_ms, top=6)
        runs[classification] = dict(step_ms=step_ms, losses=losses, peak=peak)
        del targets, leaves, opt, step

    # The TF gather's backward (``transfer_function._TakeRows``, by
    # bincount) against autograd's own backward of ``table[idx]``, which it
    # replaced: ``render_slope_grid_fused`` (K5 forward, the recompute
    # backward of the plain pipeline, as the trainer's) over the truth from
    # view 0 at full width, timed and its gradients held against each other.
    pre = problem("pre")
    pa = swd.slope_grid_plan_args(pre.plans[0], gmin, gmax, pre.params, pre.swp)
    g = torch.randn(pre.swp.inter_size + (4,), generator=torch.Generator().manual_seed(2))

    def fused_grads():
        leaves = [truth.clone().requires_grad_(), tf_true.clone().requires_grad_()]
        return torch.autograd.grad(swd.render_slope_grid_fused(*leaves, pa), leaves, g.to(dev))

    class Indexing:
        apply = staticmethod(lambda table, idx: table[idx])

    take_rows, got = tfm._TakeRows, {}
    times = {"bincount": cuda_ms(fused_grads, reps=2, warmup=1)}
    got["bincount"] = fused_grads()
    tfm._TakeRows = Indexing
    try:
        times["indexing"] = cuda_ms(fused_grads, reps=2, warmup=1)
        got["indexing"] = fused_grads()
    finally:
        tfm._TakeRows = take_rows
    print(f"render_slope_grid_fused forward + backward ({DENSE_TRAIN_N}^3, K = {pre.swp.n_planes}, "
          f"{pre.swp.inter_size} rays, view 0): the TF gather's backward by bincount "
          f"(_TakeRows) {times['bincount']:.3f} ms, by autograd's indexing "
          f"{times['indexing']:.3f} ms {card}")
    for name, a, b in zip(("d_volume", "d_tf"), got["bincount"], got["indexing"]):
        compare_grads(a, b, f"render_slope_grid_fused's {name}, bincount vs indexing",
                      pre.params.early_exit, tol_max=DENSE_GRAD_TOL)
    del got

    # Card vs CPU: one Adam step of the same small problem on each.
    small = ShearWarpProblem.from_cameras(
        cams, gmin, gmax, params,
        sw.ShearWarpParams(n_planes=32, inter_size=(32, 32), classification="post"))
    truth_small = smooth_volume(32, seed=7, device="cpu")
    with torch.no_grad():
        targets = small.render_views(None, truth_small, torch.from_numpy(default_color_map()))
    got = []
    for d in (dev, "cpu"):
        leaves, opt = start(truth_small.shape, d)
        loss = float(make_shearwarp_train_step(small, opt)(leaves, [t.to(d) for t in targets]))
        got.append((loss, {k: v.detach().cpu() for k, v in leaves.items()}))
    (l_c, p_c), (l_p, p_p) = got
    err = max([abs(l_c - l_p)] + [float((p_c[k] - p_p[k]).abs().max()) for k in p_p])
    print(f"dense trainer, card vs CPU (32^3, K = 32, 4 views of 32^2, one Adam step): loss "
          f"{l_c:.6f} / {l_p:.6f}, max|d| {err:.3e}")
    if err > 1e-4:
        raise AssertionError(f"dense trainer on the card disagrees with the CPU ({err})")
    return runs


def phase_scene(dev, card, exact_tol):
    """22. ``VolumeScene`` at full width: a 512^3 smooth volume, 512^2
    rays, the scene's default params (512 samples per ray, trilinear, the
    early exit 0.999).  The main path: K3's and K4's counts set to 0, the
    plain marcher's functions made to raise, then the target's render and
    ``SCENE_STEPS`` Adam steps on the estimate, each its render,
    ``torch.autograd`` of the MSE (K3 once, K4 once, with the exit rule),
    the update and a clamp to [0, 1]; the step time is the median of steps
    2 on; the loss must fall and the last gradients be finite and
    non-zero.  Then, off
    the main path: K3 vs plain on a 64x64 window of the view, K4 with the
    exit rule vs plain on that window over every field of
    ``testing.FIELDS`` (the backward kernels' early-exit bound, rays that
    exit counted), K4 with the exit on against the same view with it off,
    timed, and the 16^3 / 24^2 test scene on the card vs the CPU.
    Returns the counts, errors and times for the ``kernels`` line."""
    import torch

    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.models import VolumeScene
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.testing import FIELDS, field_volume, smooth_volume

    camera = build_camera(SCENE_RAYS, SCENE_RAYS, EXACT_EYES[0], (0.0, 0.0, 0.0))[0]
    gt = smooth_volume(SCENE_N, seed=7, device=dev)
    target_scene = VolumeScene.from_volume(gt, device=dev)
    scene = VolumeScene.from_volume(0.5 * gt + 0.25, device=dev)
    if scene.params.early_exit != SCENE_EXIT:
        raise AssertionError(f"the scene's early exit is {scene.params.early_exit}")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in scene.parameters.items()}

    def no_plain(*_a, **_k):
        raise AssertionError("a plain marcher ran on the card's main path")

    plain = (exact.march_exact_reference, exact.march_exact_backward_reference)
    torch.cuda.synchronize()
    exact.march_exact.launches = 0
    exact.march_exact_backward.launches = 0
    exact.march_exact_reference = exact.march_exact_backward_reference = no_plain
    try:
        with torch.no_grad():
            target = target_scene.render(camera)
        opt = torch.optim.Adam(list(leaves.values()), lr=SCENE_LR)
        losses, at = [], []
        t0 = time.perf_counter()
        for _ in range(SCENE_STEPS):
            opt.zero_grad()
            img = scene.with_parameters(leaves).render(camera)
            loss = torch.mean((img - target) ** 2)
            loss.backward()
            opt.step()
            with torch.no_grad():
                for v in leaves.values():
                    v.clamp_(0.0, 1.0)
            losses.append(float(loss.detach()))  # synchronises
            at.append(time.perf_counter())
    finally:
        exact.march_exact_reference, exact.march_exact_backward_reference = plain
    k3_launches, k4_launches = exact.march_exact.launches, exact.march_exact_backward.launches
    # ----------------------------------- end of the scene's main path
    steps_ms = np.diff([t0] + at) * 1e3
    step_ms = float(np.median(steps_ms[1:]))
    exits = int((img.detach()[..., 3] > SCENE_EXIT).sum())
    print(
        f"VolumeScene: {SCENE_N}^3, {SCENE_RAYS}^2 rays, 512 samples per ray, trilinear, early exit "
        f"{SCENE_EXIT}, {SCENE_STEPS} Adam steps (lr {SCENE_LR}): losses {losses}; step (render, "
        f"backward, Adam, clamp) median of steps 2-{SCENE_STEPS} {step_ms:.3f} ms (all steps "
        f"{', '.join(f'{x:.3f}' for x in steps_ms)} ms, host clock); K3 launches {k3_launches}, "
        f"K4 launches {k4_launches}; {exits} of {img.shape[0] * img.shape[1]} rays exit {card}"
    )
    if (k3_launches, k4_launches) != (1 + SCENE_STEPS, SCENE_STEPS):
        raise AssertionError(f"the scene launched K3 {k3_launches} and K4 {k4_launches} times")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"the scene's loss did not fall: {losses}")
    for k, v in leaves.items():
        if not bool(torch.isfinite(v.grad).all()) or float(v.grad.abs().max()) == 0.0:
            raise AssertionError(f"the scene's {k} gradient is not finite and non-zero")
    del leaves, img, target, opt

    # K3 and K4 (exit rule) vs plain on a 64x64 window of the view.
    view = exact.exact_view(camera, scene.params, device=dev)
    lo = (SCENE_RAYS - SUBSET) // 2
    sub = view.ray_pack.reshape(8, SCENE_RAYS, SCENE_RAYS)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    win = dataclasses.replace(view, ray_pack=sub.reshape(8, -1).contiguous(), width=SUBSET)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    tf = scene.tf

    def fwd(volume, v, counts=None):
        kw = {} if counts is None else dict(samples=counts[0], used=counts[1])
        args = (volume[None], slot, v.brick_boxes, tf, v.ray_pack,
                torch.zeros((v.n_rays, 4), device=dev), v.eye, v.params)
        return args, kw

    counts = [(torch.zeros(win.n_rays, dtype=torch.int32, device=dev),
               torch.zeros(1, dtype=torch.int32, device=dev)) for _ in range(2)]
    args, kw = fwd(gt, win, counts[0])
    out_w = exact.march_exact(*args, max_steps=win.max_steps, width=win.width, **kw)
    args, kw = fwd(gt, win, counts[1])
    want_w = exact.march_exact_reference(*args, max_steps=win.max_steps, **kw)
    torch.cuda.synchronize()
    what = f"K3 on a {SUBSET}x{SUBSET} window of the scene's view"
    k3_err = compare(out_w, want_w, what, exact_tol)
    check_k3_counts((out_w, *counts[0]), (want_w, *counts[1]), what, SCENE_EXIT)

    k4_err, exit_rays = 0.0, {}
    gen = torch.Generator(device="cpu").manual_seed(0)
    g_w = torch.randn((win.n_rays, 4), generator=gen).to(dev)
    for field in FIELDS:
        if field == "random":
            volume = torch.rand((SCENE_N,) * 3, generator=torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
        else:
            volume = field_volume(field, (SCENE_N,) * 3, seed=0, device=dev)
        args, _ = fwd(volume, win)
        out_f = exact.march_exact(*args, max_steps=win.max_steps, width=win.width)
        got = exact.march_exact_backward(volume, tf, win, out_f, g_w)
        want = exact.march_exact_backward_reference(volume, tf, win, out_f, g_w)
        torch.cuda.synchronize()
        exit_rays[field] = int((out_f[:, 3] > SCENE_EXIT).sum())
        for name, a, b in zip(("d_volume", "d_tf"), got, want):
            compare_grads(a, b, f"K4, exit rule, {field} field, {SUBSET}x{SUBSET} window: {name}",
                          SCENE_EXIT, expect_zero=field == "top" and name == "d_volume")
            k4_err = max(k4_err, float((a - b).abs().max()))
        del volume, got, want
    print(f"  rays of the {win.n_rays} that exit, by field: {exit_rays}")
    if sum(exit_rays.values()) == 0:
        raise AssertionError("no ray of the window exits: the exit rule was not exercised")

    # K4 with the exit on against the same view with it off, over the truth.
    off = dataclasses.replace(view, params=dataclasses.replace(view.params, early_exit=1.1))
    g = torch.randn((view.n_rays, 4), generator=torch.Generator().manual_seed(1)).to(dev)
    times, samples = {}, {}
    for name, v in (("on", view), ("off", off)):
        n_samples = torch.zeros(v.n_rays, dtype=torch.int32, device=dev)
        args, _ = fwd(gt, v)
        out_v = exact.march_exact(*args, max_steps=v.max_steps, width=v.width, samples=n_samples)
        samples[name] = int(n_samples.sum())
        times[name] = cuda_ms(lambda: exact.march_exact_backward(gt, tf, v, out_v, g), reps=5,
                              warmup=1)
    # K4's bound as phase 13's: the volume read and d_volume written, the ray
    # pack, out and g, the TF and d_tf; the samples K3 composited.
    k4_on_bound = bound(bytes_=2 * gt.numel() * 4 + view.n_rays * 16 * 4 + 2 * TF_BYTES,
                        ops=samples["on"] * K4_OPS_PER_SAMPLE["trilinear"])
    print(f"K4 on the scene's view ({SCENE_RAYS}^2 rays over the {SCENE_N}^3 truth, TF gradient on): "
          f"exit on {times['on']:.4f} ms over {samples['on']} samples (bound "
          f"{k4_on_bound[0]:.4f} ms, {k4_on_bound[1]}), exit off {times['off']:.4f} ms over "
          f"{samples['off']} samples {card}")

    # The 16^3 / 24^2 test scene, card vs CPU.
    small = smooth_volume(16, seed=7, device="cpu")
    small_params = RenderParams(n_samples_per_ray=32, data_source_range=(0.0, 1.0),
                                filter_mode="trilinear")
    cam_small = build_camera(24, 24, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))[0]
    results = []
    for d in (dev, "cpu"):
        s = VolumeScene.from_volume(small, params=small_params, device=d)
        lv = {k: v.clone().requires_grad_() for k, v in s.parameters.items()}
        out = s.with_parameters(lv).render(cam_small)
        out.square().mean().backward()
        results.append((out.detach().cpu(), lv["density"].grad.cpu(), lv["tf"].grad.cpu()))
    (img_c, *grads_c), (img_p, *grads_p) = results
    compare(img_c, img_p, "VolumeScene 16^3 / 24^2, card vs CPU: image", exact_tol)
    for name, a, b in zip(("d_density", "d_tf"), grads_c, grads_p):
        compare_grads(a, b, f"VolumeScene 16^3 / 24^2, card vs CPU: {name}", SCENE_EXIT)
    return dict(k3_launches=k3_launches, k4_launches=k4_launches, k3_err=k3_err,
                k4_err=k4_err, k4_on_ms=times["on"], k4_off_ms=times["off"],
                k4_on_bound=k4_on_bound, step_ms=step_ms)


def phase_scripts(card):
    """23. The benchmark scripts (``libre_tpu_torch/benchmarks``), each
    ``python -m`` in a process of its own (``SCRIPT_RUNS``), each with its
    wall time.  Each script holds one call of every kernel it runs against
    its plain version on the same inputs, and exits non-zero past the
    kernel's bound; its output's last two lines give those checks' largest
    errors and its render kernels' launch counts (the checks' launches not
    counted), and a kernel it launched must have been checked.
    ``demo_out_of_core`` writes into a temporary directory, and its record
    must have the reference's keys.  Returns the summed launch counts and
    the largest errors, by kernel."""
    from libre_tpu_torch.benchmarks import demo_out_of_core

    root = os.path.dirname(os.path.abspath(__file__))
    totals, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for module, argv in SCRIPT_RUNS:
            if module == "demo_out_of_core":
                record = os.path.join(tmp, "ooc_run.json")
                argv = argv + ["--store", os.path.join(tmp, "ooc.lod"), "--out", record]
                print(f"demo_out_of_core cut from its default 1024^3 to: {' '.join(argv[:6])}")
            launched, checked, _lines = run_script(module, argv, card, root)
            for kernel, n in launched.items():
                totals[kernel] = totals.get(kernel, 0) + n
            for kernel, err in checked.items():
                errors[kernel] = max(errors.get(kernel, 0.0), err)
            if module == "demo_out_of_core":
                with open(record) as f:
                    rec = json.load(f)
                if set(rec) != set(demo_out_of_core.RECORD_KEYS) or any(
                        set(rec[k]) != set(demo_out_of_core.RUN_KEYS)
                        for k in ("incore", "out_of_core")):
                    raise AssertionError(f"demo_out_of_core's record has keys {sorted(rec)}")
    print(f"  the scripts' kernel launches: {totals}; their checks' max|kernel - plain|: "
          f"{errors}")
    for kernel in ("post_sweep", "store_grid_bwd", "exact_march", "exact_march_bwd"):
        if totals.get(kernel, 0) == 0:
            raise AssertionError(f"the scripts launched no {kernel}")
    return totals, errors


def phase_entry(dev, card, exact_tol):
    """24. ``entry()`` on the card: its ``fn`` on its example inputs (K3
    once; the count set to 0 before and read after), held against the
    plain march on the same inputs on the CPU, and timed."""
    import torch

    from libre_tpu_torch.entry import entry
    from libre_tpu_torch.ops import exact

    fn, args = entry()
    torch.cuda.synchronize()
    exact.march_exact.launches = 0
    img = fn(*args)
    torch.cuda.synchronize()
    launches = exact.march_exact.launches
    if launches != 1 or tuple(img.shape) != (128, 128, 4):
        raise AssertionError(f"entry(): {launches} K3 launches, image {tuple(img.shape)}")
    fn_p, args_p = entry(device="cpu")
    err = compare(img.cpu(), fn_p(*args_p), "entry() on the card vs the plain march", exact_tol)
    ms = cuda_ms(lambda: fn(*args), reps=10)
    print(f"entry(): 32^3, 128x128 rays, 128 samples per ray: {ms:.4f} ms per call {card}")
    return launches, err


# ============================================================ 25-29. M9
MESH_SHAPES = ((2, 2), (4, 1))  # (n_brick, n_ray): four logical shards of the card
SLAB_MB = 640  # a 320 MB derived budget under the 512 MiB store: slab mode, all 4096 bricks in the atlas
MESH_EXITS = (1.1, 0.999)  # early exit off (the fold regroups floats), on (local to a segment)
SHARD_TRAIN_STEPS = 5
TWO_PROCESS_N = 256  # phase 29's store and slope grid (256^3, 256^2 rays, 512 planes)


def logical_mesh(dev, n_brick, n_ray):
    from libre_tpu_torch.parallel import make_mesh

    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[dev] * (n_brick * n_ray))


@contextlib.contextmanager
def captured(module, name):
    """Wrap ``module.name`` while entered; the list it yields gets the
    (args, kwargs) of every call.  The wrapper carries the function's
    attributes while entered (a kernel wrapper counts its launches on the
    module's name) and hands them back on exit."""
    real, calls = getattr(module, name), []

    def call(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    call.__dict__.update(real.__dict__)
    setattr(module, name, call)
    try:
        yield calls
    finally:
        real.__dict__.update(call.__dict__)
        setattr(module, name, real)


def k1_site(calls, what, card):
    """The last recorded K1 launch of ``calls`` ((name, args) of a
    ``Recorder``) at a sharded call site: launched again on its operands
    as they are now (a training step's optimizer has updated the TF in
    place since), bit-equal to the plain sweep on them, timed, with its
    bound → (ms, bound)."""
    import torch

    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp_bricked as swb

    args = [a for name, a in calls if name == "post_sweep"][-1]
    ops, _recorded = k1_operands(args)
    out, t_out = swb.post_sweep(*ops[:4], **ops[4])
    work = k1_work(*ops)
    torch.cuda.synchronize()
    if not (torch.equal(out, work["want"]) and torch.equal(t_out, work["t_want"])):
        raise AssertionError(f"{what}: K1 is not bit-equal to the plain sweep")
    ms = cuda_ms(lambda: _kernels.launch("post_sweep", *args), reps=20)
    print(f"  K1 at {what}: {tuple(out.shape)} rays x {ops[2].a0.shape[0]} planes over "
          f"{tuple(ops[0].shape)}: {ms:.4f} ms, bit-equal to plain; bound {work['bound'][0]:.4f} ms "
          f"({work['bound'][1]}) {card}")
    return ms, work["bound"]


def k2_site(calls, what, card):
    """The last recorded K2 launch of ``calls`` at a sharded training
    step: within the backward kernels' bound of the plain backward on its
    operands (early exit off), timed with its ``d_store`` zeroing, with
    its bound → (ms, bound, max |d|)."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_grad as swg

    args = [a for name, a in calls if name == "store_grid_bwd"][-1]
    (store, tf, a0, a1, wa, dl, act, view, corr, rgb_in, t_in, out, t_out, g, _ds, _dtf,
     k, nc, nb, v, u, diff_tf, wb0, wb1, wc0, wc1, _sb, _sc, early_exit) = args
    tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=view, corr=corr,
                             rgb_in=rgb_in, t_in=t_in)
    kw = dict(wb=(wb0, wb1), wc=(wc0, wc1), early_exit=early_exit, diff_tf=bool(diff_tf))
    store, tf = store.detach(), tf.detach()  # the recorded training leaves
    got = swg.store_grid_backward(store, tf, tables, out, t_out, g, **kw)
    want = swg.store_grid_backward_reference(store, tf, tables, out, t_out, g, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        compare_grads(a, b, f"{what}, K2 gradient {i} vs plain", early_exit)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ug = view[0] + view[1] * torch.arange(u, device=store.device)
    vg = view[5] + view[2] * torch.arange(v, device=store.device)
    xb = view[3] + ug[None, :] * dl[:, None]
    xc = view[4] + vg[None, :] * dl[:, None]
    in_box = int((((xb >= wb0) & (xb < wb1)).sum(1) * ((xc >= wc0) & (xc < wc1)).sum(1)).sum())
    b = bound(bytes_=2 * store.numel() * 4 + v * u * 15 * 4 + 2 * TF_BYTES + k * 5 * 4,
              ops=in_box * K2_OPS_PER_SAMPLE)
    ms = cuda_ms(lambda: swg.store_grid_backward(store, tf, tables, out, t_out, g, **kw), reps=10)
    print(f"  K2 at {what}: {v}x{u} rays x {k} planes over {tuple(store.shape)}: {ms:.4f} ms; "
          f"bound {b[0]:.4f} ms ({b[1]}) {card}")
    return ms, b, err


def k3_site(calls, slot_bytes, filter_mode, what, card):
    """The first recorded K3 launch of ``calls`` (an f32 brick set) timed,
    with its bound from its relaunched counts → (ms, bound)."""
    from libre_tpu_torch.ops import _kernels

    args = [a for name, a in calls if name == "exact_march"][0]
    ms = cuda_ms(lambda: _kernels.launch("exact_march", *args), reps=10)
    _out, samples, used = k3_counts(args)
    b = k3_bound_of(samples, used, slot_bytes, int(args[11]), int(samples.shape[0]),
                    filter_mode, True)
    print(f"  K3 at {what}: {int(samples.shape[0])} rays, {int(samples.sum())} samples: "
          f"{ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}) {card}")
    return ms, b


def phase_sharded_orbit(dev, card, engine, poses):
    """25. The sharded bricked orbit: the 8 poses at screen-space error 1
    (all 4096 finest bricks, a 512^3 store, K = 512) through
    ``RenderEngine.render_bricked`` with ``engine.mesh`` a mesh of logical
    shards of the card, (n_brick, n_ray) = (2, 2) and (4, 1): on phase 4's
    engine (the replicated store, the cached one) and on an engine of
    ``SLAB_MB`` (a slab per brick-axis shard, assembled per view), each
    with the early exit off and at 0.999.  K1's count and the engine's
    ``sharded_frames`` are set to 0 just before each run and read just
    after: one K1 launch per shard per frame, every frame sharded.  Each
    frame is held to the same engine's one-device frame: 2e-5 (exit off),
    below 2e-3 (0.999).  Then one sharded frame's split: the sharded sweep
    (tables, 4 K1, fold) and the fold alone (CUDA events), and one shard's
    K1 bit-equal to plain and timed.  Returns (K1 launches, sites, max
    |K1 − plain|)."""
    import torch

    from libre_tpu_torch.data.datasource import DataSource
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.parallel import bricked_sharded as bs
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.testing import SHARD_TOL_EXIT_OFF, SHARD_TOL_EXIT_ON

    params = {e: RenderParams(n_samples_per_ray=512, data_source_range=engine.data_source_range,
                              early_exit=e) for e in MESH_EXITS}
    kw = dict(screen_space_error=1.0)
    engine.mesh = None
    refs = {e: [engine.render_bricked(cam, fr, params=params[e], **kw)[0] for cam, fr in poses]
            for e in MESH_EXITS}
    slab_engine = RenderEngine(DataSource(URI), max_gpu_cache_mb=SLAB_MB, device=dev)
    launches, sites, split = 0, [], None
    for mode, eng in (("replicated", engine), ("slabs", slab_engine)):
        for n_brick, n_ray in MESH_SHAPES:
            eng.mesh = logical_mesh(dev, n_brick, n_ray)
            for e in MESH_EXITS:
                tol = SHARD_TOL_EXIT_OFF if e > 1.0 else SHARD_TOL_EXIT_ON
                torch.cuda.synchronize()
                swb.post_sweep.launches = 0
                eng.sharded_frames = 0
                frame_ms, errs = [], []
                for (cam, fr), ref in zip(poses, refs[e]):
                    t0 = time.perf_counter()
                    img, stats = eng.render_bricked(cam, fr, params=params[e], **kw)
                    torch.cuda.synchronize()
                    frame_ms.append((time.perf_counter() - t0) * 1e3)
                    errs.append(float((img - ref).abs().max()))
                n_k1, n_sharded = swb.post_sweep.launches, eng.sharded_frames
                # ----------------------------------------- end of this run
                launches += n_k1
                if n_sharded != len(poses) or n_k1 != len(poses) * n_brick * n_ray:
                    raise AssertionError(
                        f"{mode} {n_brick}x{n_ray}: {n_sharded} sharded frames of {len(poses)}, "
                        f"{n_k1} K1 launches")
                if stats.n_passes != n_brick or (mode == "slabs") != (len(eng._store_cache) == 0):
                    raise AssertionError(f"{mode} {n_brick}x{n_ray}: not in {mode} mode")
                if max(errs) > tol:
                    raise AssertionError(f"{mode} {n_brick}x{n_ray} exit {e}: max|d| {max(errs)} "
                                         f"from the one-device frames, bound {tol}")
                steady = sorted(frame_ms[1:])
                print(f"sharded orbit, {mode} store, (brick, ray) = ({n_brick}, {n_ray}), exit {e}: "
                      f"{n_sharded} sharded frames, {n_k1} K1 launches; max|d| vs one device "
                      f"{max(errs):.3e} (bound {tol}); frame ms first {frame_ms[0]:.1f}, steady "
                      f"median {steady[len(steady) // 2]:.3f}, min {steady[0]:.3f} {card}")
            if mode == "replicated" and (n_brick, n_ray) == MESH_SHAPES[0]:
                cam, fr = poses[-1]
                with captured(bs, "render_store_grid_sharded") as sweeps, \
                        captured(bs, "fold_rows") as folds, Recorder("post_sweep") as rec:
                    eng.render_bricked(cam, fr, params=params[1.1], **kw)
                torch.cuda.synchronize()
                (s_args, s_kw), = sweeps
                (f_args, f_kw), = folds
                sweep_ms = cuda_ms(lambda: bs.render_store_grid_sharded(*s_args, **s_kw), reps=10)
                fold_ms = cuda_ms(lambda: bs.fold_rows(*f_args, **f_kw), reps=10)
                # The host's share: the per-shard Python loop enqueues 4
                # wrappers' launches and the tables and moves around them.
                t0 = time.perf_counter()
                for _ in range(10):
                    bs.render_store_grid_sharded(*s_args, **s_kw)
                host_ms = (time.perf_counter() - t0) * 1e3 / 10
                torch.cuda.synchronize()
                print(f"  one sharded frame's sweep (tables, {len(rec.calls)} K1, fold): "
                      f"{sweep_ms:.4f} ms device; the fold {fold_ms:.4f} ms, {fold_ms / sweep_ms:.4f} "
                      f"of it; the host enqueues the sweep in {host_ms:.4f} ms a call "
                      f"({host_ms / eng.mesh.size:.4f} ms a shard) {card}")
                split = k1_site(rec.calls, "a shard of the 2x2 orbit frame", card)
    engine.mesh = None
    del slab_engine
    free_device_memory()
    sites.append(("K1", "render_store_grid_sharded, sharded orbit (2x2, 4x1; replicated, slabs)",
                  launches, *split))
    return launches, sites


def phase_sharded_training(dev, card, problem, store, tf, targets):
    """26. Phase 7's store trainer over logical shards of the card: its 4
    views (one major axis and one march sign: the orbit's), 512^2 slope
    grids, K = 512, over the orbit's 512^3 store.  From the flat init, the
    loss and its store and TF gradients of the views x rows loss on a 2x2
    mesh and of the slab loss on n_brick = 2 and 4 against the one-device
    loss (rtol 1e-6) and gradients (1e-5); then ``SHARD_TRAIN_STEPS`` Adam
    steps of each (lr 5e-2), K1's and K2's counts set to 0 just before
    and read just after: the loss falls, K1 and K2 launch once per view
    per ray shard per brick shard of the view's.  Returns (K1, K2
    launches, sites, K2 max |d|)."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.testing import GRAD_TOL_MAX, SHARD_GRAD_TOL, SHARD_LOSS_RTOL
    from libre_tpu_torch.train import store_trainer as st

    covered = store > -0.5
    init = torch.where(covered, 0.5, swb.SENTINEL)
    leaf, tf_one = init.clone().requires_grad_(), tf.clone().requires_grad_()
    loss_one = st.make_loss_fn(problem)(leaf, tf_one, targets)
    loss_one.backward()
    n_views = len(problem.views)
    print(f"sharded training views: phase 7's {n_views}, major axis {problem.axis}, march sign "
          f"{sorted({float(v[9]) for v in problem.views})}")
    configs = (("views x rows, replicated store", 2, 2, False),
               ("slab-sharded store", 2, 1, True), ("slab-sharded store", 4, 1, True))
    k1_total = k2_total = 0
    k1_site_ms = k2_site_ms = None
    k2_err = 0.0
    for what, n_brick, n_ray, slabs in configs:
        mesh = logical_mesh(dev, n_brick, n_ray)
        name = f"{what} ({n_brick}, {n_ray})"
        tf_p = tf.clone().requires_grad_()
        if slabs:
            leaves = [s.requires_grad_() for s in st.shard_store_slabs_uniform(init, n_brick)]
            loss = st.make_slab_loss_fn(problem, mesh)(leaves, tf_p, targets)
        else:
            leaves = [init.clone().requires_grad_()]
            loss = st.make_loss_fn(problem, mesh)(leaves[0], tf_p, targets)
        loss.backward()
        d_store = torch.cat([x.grad for x in leaves])
        rel = abs(float(loss.detach()) - float(loss_one.detach())) / abs(float(loss_one.detach()))
        g_err = float((d_store - leaf.grad).abs().max())
        t_err = float((tf_p.grad - tf_one.grad).abs().max())
        print(f"{name}: loss {float(loss.detach()):.9g} vs one device {float(loss_one.detach()):.9g} (rel "
              f"{rel:.3e}); store gradient max|d| {g_err:.3e} of max {float(leaf.grad.abs().max()):.3e},"
              f" TF gradient max|d| {t_err:.3e} of max {float(tf_one.grad.abs().max()):.3e}")
        # The store gradient is ~4e-7 at most here, so 1e-5 holds it to
        # nothing: it is also held, normalised, to the backward kernels'
        # bound against their plain versions (GRAD_TOL_MAX).
        g_rel = g_err / float(leaf.grad.abs().max())
        if rel > SHARD_LOSS_RTOL or g_err > SHARD_GRAD_TOL or t_err > SHARD_GRAD_TOL \
                or g_rel > GRAD_TOL_MAX:
            raise AssertionError(f"{name}: off the one-device step ({rel}, {g_err}, {g_rel}, "
                                 f"{t_err})")
        del leaves, tf_p, loss, d_store
        # --------------------------------------------- the training run
        tf_p = tf.clone().requires_grad_()
        if slabs:
            leaves = [s.requires_grad_() for s in st.shard_store_slabs_uniform(init, n_brick)]
            step = st.make_slab_train_step(problem, torch.optim.Adam(leaves + [tf_p], lr=5e-2), mesh)
            params = {"slabs": leaves, "tf": tf_p}
        else:
            leaves = [init.clone().requires_grad_()]
            step = st.make_train_step(problem, torch.optim.Adam(leaves + [tf_p], lr=5e-2), mesh)
            params = {"store": leaves[0], "tf": tf_p}
        torch.cuda.synchronize()
        swb.post_sweep.launches = 0
        swg.store_grid_backward.launches = 0
        losses, ends = [], []
        # The last step of the 4-slab run records its launches' operands
        # (recording every step would hold each launch's slab and d_store).
        rec = Recorder("post_sweep", "store_grid_bwd")
        t0 = time.perf_counter()
        with adam_counted(name, (len(leaves) + 1) * SHARD_TRAIN_STEPS):
            for i in range(SHARD_TRAIN_STEPS):
                last = slabs and n_brick == 4 and i == SHARD_TRAIN_STEPS - 1
                with rec if last else contextlib.nullcontext():
                    losses.append(float(step(params, targets)))
                ends.append(time.perf_counter())
        n_k1, n_k2 = swb.post_sweep.launches, swg.store_grid_backward.launches
        # ------------------------------------------ end of the training run
        k1_total += n_k1
        k2_total += n_k2
        per_step = n_views * n_ray * (n_brick if slabs else 1)
        if n_k1 != per_step * SHARD_TRAIN_STEPS or n_k2 != per_step * SHARD_TRAIN_STEPS:
            raise AssertionError(f"{name}: K1 {n_k1}, K2 {n_k2} launches in "
                                 f"{SHARD_TRAIN_STEPS} steps, want {per_step} a step each")
        if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: the loss did not fall: {losses}")
        steps_ms = np.diff([t0] + ends) * 1e3
        print(f"{name}: {SHARD_TRAIN_STEPS} Adam steps, losses {losses}; K1 {n_k1 // SHARD_TRAIN_STEPS} "
              f"and K2 {n_k2 // SHARD_TRAIN_STEPS} launches a step; step median of 2-"
              f"{SHARD_TRAIN_STEPS} {float(np.median(steps_ms[1:])):.3f} ms (all "
              f"{', '.join(f'{x:.3f}' for x in steps_ms)}) {card}")
        if slabs and n_brick == 4:
            k1_site_ms = k1_site(rec.calls, "a slab shard's forward (n_brick 4)", card)
            ms, b, k2_err = k2_site(rec.calls, "a slab shard's backward (n_brick 4)", card)
            k2_site_ms = (ms, b)
        del leaves, tf_p, params, step, rec
        free_device_memory()
    sites = [("K1", "store trainer forward, sharded (2x2 replicated; slabs on 2, 4)", k1_total,
              *k1_site_ms),
             ("K2", "store trainer backward, sharded (2x2 replicated; slabs on 2, 4)", k2_total,
              *k2_site_ms)]
    return k1_total, k2_total, sites, k2_err


def phase_sharded_exact(dev, card, exact_tol):
    """27. ``VolumeScene.render_sharded`` at phase 22's width (a 512^3
    smooth volume, 512^2 rays, its default params) on a 2x2 mesh of
    logical shards against ``render``: K3's count set to 0 before and read
    after, once per shard (one pass each); the image within K3's bound.
    One shard's launch timed with its bound.  Returns (K3 launches,
    sites)."""
    import torch

    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.models import VolumeScene
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.testing import smooth_volume

    camera = build_camera(SCENE_RAYS, SCENE_RAYS, EXACT_EYES[0], (0.0, 0.0, 0.0))[0]
    scene = VolumeScene.from_volume(smooth_volume(SCENE_N, seed=7, device=dev), device=dev)
    mesh = logical_mesh(dev, 2, 2)
    with torch.no_grad():
        one = scene.render(camera)
        torch.cuda.synchronize()
        exact.march_exact.launches = 0
        with Recorder("exact_march") as rec:
            got = scene.render_sharded(mesh, camera)
        torch.cuda.synchronize()
        launches = exact.march_exact.launches
        # --------------------------------------------- end of the main path
        if launches != 4:
            raise AssertionError(f"render_sharded launched K3 {launches} times, want 4")
        compare(got, one, "VolumeScene.render_sharded (2x2) vs render", exact_tol)
        one_ms = cuda_ms(lambda: scene.render(camera), reps=5)
        sharded_ms = cuda_ms(lambda: scene.render_sharded(mesh, camera), reps=5)
        print(f"VolumeScene at {SCENE_N}^3, {SCENE_RAYS}^2 rays: render {one_ms:.4f} ms, "
              f"render_sharded (2x2) {sharded_ms:.4f} ms {card}")
        ms, b = k3_site(rec.calls, scene.bricks.data[0].numel() * 4, scene.params.filter_mode,
                        "shard (0, 0) of the sharded scene", card)
    return launches, [("K3", "render_rays_sharded, VolumeScene.render_sharded (2x2)", launches,
                       ms, b)]


def phase_mesh_apps(dev, card):
    """28. The apps on a mesh of logical shards of the card:
    ``render_cli --mesh 2x2 --mesh-devices`` (four times the card) at
    512x512 (K1 once per shard; the frame against the one-device CLI
    frame's PNG, at most one 8-bit step), then ``RenderService`` with a 2x2
    ``Mesh`` over HTTP on 127.0.0.1: 3 orbit poses, each served frame
    (before JPEG) bit-equal to the engine's sharded frame at the same
    camera.  K1's count and ``sharded_frames`` are set to 0 before each
    and read after.  Returns K1 launches."""
    import urllib.request

    import torch

    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.utils.image import read_image

    pngs = {}
    launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        for name, extra in (("one", []), ("mesh", ["--mesh", "2x2", "--mesh-devices",
                                                   ",".join([str(dev)] * 4)])):
            torch.cuda.synchronize()
            swb.post_sweep.launches = 0
            rc = render_cli.main(["--volume", URI, "--width", "512", "--height", "512",
                                  "--device", str(dev), "--output-dir",
                                  os.path.join(out_dir, name)] + extra)
            torch.cuda.synchronize()
            n = swb.post_sweep.launches
            if rc != 0 or n != (4 if name == "mesh" else 1):
                raise AssertionError(f"render_cli {name}: exit {rc}, {n} K1 launches")
            if name == "mesh":
                launches += n
            pngs[name] = read_image(os.path.join(out_dir, name, "frame_000000.png")).astype(np.int32)
    png_err = int(np.abs(pngs["mesh"] - pngs["one"]).max())
    print(f"render_cli --mesh 2x2 at 512x512: 4 K1 launches; PNG max|d| vs one device {png_err}")
    if png_err > 1 or pngs["mesh"].max() == 0:
        raise AssertionError(f"render_cli --mesh frame off the one-device frame ({png_err})")

    svc = RenderService(URI, width=512, height=512, host="127.0.0.1", port=0, device=dev,
                        mesh=logical_mesh(dev, 2, 2))
    served = []
    real_frame = svc.render_frame

    def render_frame(progressive=False):
        canvas = real_frame(progressive)
        served.append(canvas)
        return canvas

    svc.render_frame = render_frame
    svc.server.start()
    host, port = svc.server.address
    try:
        def call(path, method="GET", body=None):
            data = json.dumps(body).encode() if body is not None else None
            req = urllib.request.Request(f"http://{host}:{port}{path}", data=data, method=method)
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.read()

        call("/params", "PUT", {"synchronous": True, "sse": SERVE_SSE})
        poses = orbit_cameras()[::3]
        torch.cuda.synchronize()
        swb.post_sweep.launches = 0
        svc.engine.sharded_frames = 0
        latency = []
        for i, (_cam, frustum) in enumerate(poses):
            call("/camera", "PUT", {"modelview": frustum.mv.tolist()})
            t0 = time.perf_counter()
            if call("/image-jpeg", "POST", {})[:2] != b"\xff\xd8":
                raise AssertionError(f"sharded service pose {i}: no JPEG")
            latency.append((time.perf_counter() - t0) * 1e3)
            cam, fr = svc.view_camera(512, 512, 0.0)
            img, _ = svc.engine.render_bricked(cam, fr, **svc.frame_keywords())
            if not np.array_equal(served[-1], img.cpu().numpy()):
                raise AssertionError(f"sharded service pose {i}: the served frame is not the "
                                     f"engine's sharded frame")
        n_k1, n_sharded = swb.post_sweep.launches, svc.engine.sharded_frames
        call("/exit", "POST", {})
    finally:
        svc.server.stop()
    # Each pose: the served frame and the engine's own, 4 shards each.
    if n_sharded != 2 * len(poses) or n_k1 != 8 * len(poses):
        raise AssertionError(f"sharded service: {n_sharded} sharded frames, {n_k1} K1 launches")
    launches += n_k1
    print(f"RenderService over a 2x2 mesh: {len(poses)} orbit requests, served frames bit-equal "
          f"to the engine's sharded frames; request ms {', '.join(f'{x:.1f}' for x in latency)} "
          f"{card}")
    return launches


def phase_two_process(dev, card):
    """29. Two processes on this machine, each on the card, in one gloo
    group (``parallel/two_process.py`` at 256^3 / 256^2 rays / 512
    planes): the frame-state broadcast, the rows gathered across the
    processes against the one-device grid, the summed slab loss and TF
    gradient (``all_reduce``) against the one-device ones."""
    from libre_tpu_torch.parallel import two_process

    t0 = time.perf_counter()
    outs = two_process.run(str(dev), vox=TWO_PROCESS_N, img=TWO_PROCESS_N, timeout=300)
    for rank, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"OK rank={rank} "))
        print(f"two processes, rank {rank}: {line.split(' ', 2)[2]}")
    print(f"two processes (gloo, one card): {time.perf_counter() - t0:.1f} s wall {card}")


SET_SPLIT = 8  # phase 30: the 512^3 smooth truth in 8^3 bricks of 64^3, two ghost voxels
SET_STEPS = 5
SET_LR = 1e-2
# K4's slab test per brick and ray (exact_sample.cuh's brick_span: per axis
# 2 subtractions, 2 products and 4 min/max; the clip interval's 2 and the
# test), which it runs for every brick of its set.
K4_OPS_PER_BRICK = 27


def k4_set_site(call, what, card):
    """A recorded ``march_exact_backward`` call over a brick set
    ((args, kwargs) of ``captured``): timed as the trainers' K4 (its
    ``d_volume`` zeroing included), its samples counted by K3 over the
    same set (a relaunch, not a main-path launch), with its bound: the
    set's f32 density read and d_volume written once, the ray pack, out
    and g, the TF and d_tf; every sample's operations and a slab test per
    ray and brick → (ms, bound)."""
    import torch

    from libre_tpu_torch.ops import exact

    (volume, tf, view, out, g), kw = call
    volume, tf = volume.detach(), tf.detach()
    n_bricks = volume.shape[0]
    samples = torch.zeros(view.n_rays, dtype=torch.int32, device=volume.device)
    exact.march_exact(
        volume, torch.arange(n_bricks, dtype=torch.int32, device=volume.device),
        view.brick_boxes, tf, view.ray_pack, torch.zeros_like(out), view.eye, view.params,
        max_steps=view.max_steps, width=view.width, samples=samples)
    n_samples = int(samples.sum())
    ms = cuda_ms(lambda: exact.march_exact_backward(volume, tf, view, out, g, **kw), reps=5,
                 warmup=1)
    b = bound(bytes_=2 * volume.numel() * 4 + view.n_rays * 16 * 4 + n_bricks * 16 * 4
              + 2 * TF_BYTES,
              ops=n_samples * K4_OPS_PER_SAMPLE[view.params.filter_mode]
              + view.n_rays * n_bricks * K4_OPS_PER_BRICK)
    print(f"  K4 at {what}: {view.n_rays} rays over {n_bricks} bricks of "
          f"{tuple(volume.shape[1:])}, {n_samples} samples: {ms:.4f} ms; bound {b[0]:.4f} ms "
          f"({b[1]}) {card}")
    return ms, b


def k4_set_window(call, what, seed):
    """K4 over the set of a recorded call vs its plain version on a
    ``SUBSET`` x ``SUBSET`` window in the middle of the call's rays: K3
    over the set marches the window from a zero carry, a seeded normal
    cotangent, the backward tolerances of ``compare_grads`` for the
    call's early exit → the largest absolute difference."""
    import torch

    from libre_tpu_torch.ops import exact

    (volume, tf, view, _out, _g), _kw = call
    volume, tf = volume.detach(), tf.detach()
    height = view.n_rays // view.width
    y0, x0 = (height - SUBSET) // 2, (view.width - SUBSET) // 2
    pack = view.ray_pack.reshape(8, height, view.width)[:, y0:y0 + SUBSET, x0:x0 + SUBSET]
    win = dataclasses.replace(view, ray_pack=pack.reshape(8, -1).contiguous(), width=SUBSET)
    with torch.no_grad():
        out = exact.render_marcher_diff(volume, tf, win)
    g = torch.randn((win.n_rays, 4), generator=torch.Generator().manual_seed(seed)).to(
        volume.device)
    got = exact.march_exact_backward(volume, tf, win, out, g)
    want = exact.march_exact_backward_reference(volume, tf, win, out, g)
    torch.cuda.synchronize()
    for name, a, b in zip(("d_volume", "d_tf"), got, want):
        compare_grads(a, b, f"K4 over the set, {what}, {SUBSET}x{SUBSET} window: {name}",
                      win.params.early_exit, EXACT_GRAD_TOL_MAX)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_exact_set(dev, card, exact_tol):
    """30. The exact gradient over a brick set at full width: the 512^3
    ``smooth_volume`` (seed 7) in 8^3 bricks of 64^3 with two ghost voxels
    (``testing.split_into_bricks``: 512 bricks of 68^3, 644 MB of f32
    density), sorted front to back from eye 0 (``shard_bricks_front_to_back``),
    512^2 rays, trilinear, 512 samples per unit, the 256-entry TF.  The
    main path: the mesh-sharded exact trainer (``train.trainer``) from a
    0.5 density and the grayscale TF against the truth's render under the
    default colormap, ``SET_STEPS`` Adam steps (lr ``SET_LR``, early exit
    off) on a 1x1 mesh and on a 2x2 mesh of logical shards of the card,
    K3's and K4's counts set to 0 before each and read after (one of each
    per shard and step); the loss must fall, the first 2x2 step's loss and
    gradients agree with the 1x1 step's (loss rtol ``SHARD_LOSS_RTOL``,
    gradients within the exit-off backward bound of the largest entry),
    and each step time is the median of steps 2 on; then
    ``VolumeScene.render`` over the same set with the early exit on
    (0.999): the target's render, one forward and backward of the
    estimate's MSE (K3 twice, K4 once).  Off the main path: each K4 site
    (the 1x1 trainer over 512 bricks, one 2x2 shard over 256, the scene
    over 512) timed with its bound and held against the plain version on
    a 64x64 window of its rays; K3 on the 1x1 trainer's window.  Returns
    the counts, errors and sites for the ``kernels`` line."""
    import functools

    import torch

    from libre_tpu_torch.apps.render_cli import build_camera
    from libre_tpu_torch.models import VolumeScene
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops.reference import RenderParams, max_steps_for_bricks
    from libre_tpu_torch.ops.transfer_function import default_color_map, grayscale_ramp
    from libre_tpu_torch.parallel.render import shard_bricks_front_to_back
    from libre_tpu_torch.testing import (
        SHARD_LOSS_RTOL,
        smooth_volume,
        split_into_bricks,
    )
    from libre_tpu_torch.train import InverseRenderProblem, init_state, make_train_step

    t0 = time.perf_counter()
    gmin, gmax = GMIN_GMAX
    camera = build_camera(SCENE_RAYS, SCENE_RAYS, EXACT_EYES[0], (0.0, 0.0, 0.0))[0]
    eye, dirs, cos_z, _ = ray_ops.make_rays(camera.inv_proj, camera.inv_mv, camera.viewport,
                                            device=dev)
    dirs, tnp = dirs.reshape(-1, 3), ray_ops.near_plane_t(cos_z.reshape(-1), camera.near)
    truth = smooth_volume(SCENE_N, seed=7, device=dev).cpu().numpy()
    bricks = split_into_bricks(truth, SET_SPLIT, 2, device=dev)
    del truth
    sharded, _ = shard_bricks_front_to_back(bricks, eye.cpu().numpy(), 2)
    if sharded.num_bricks != SET_SPLIT ** 3:
        raise AssertionError(f"the set was padded to {sharded.num_bricks} bricks")
    del bricks
    params = RenderParams(n_samples_per_ray=512, data_source_range=(0.0, 1.0),
                          filter_mode="trilinear", early_exit=1.1)
    problem = InverseRenderProblem(
        bricks=sharded, global_min=gmin, global_max=gmax, params=params,
        max_steps=max_steps_for_bricks(sharded.world_min.cpu().numpy(),
                                       sharded.world_max.cpu().numpy(), params.step_size),
        width=SCENE_RAYS,
    )
    tf_true = torch.from_numpy(default_color_map()).to(dev)
    with torch.no_grad():
        target = problem.render(logical_mesh(dev, 1, 1), sharded.data, tf_true, eye, dirs, tnp)
    start = dataclasses.replace(
        problem, bricks=sharded._replace(data=torch.full_like(sharded.data, 0.5)))
    print(f"exact set: {SCENE_N}^3 smooth truth in {sharded.num_bricks} bricks of "
          f"{tuple(sharded.data.shape[1:])} ({sharded.data.numel() * 4 / 1e6:.0f} MB f32), "
          f"{SCENE_RAYS}^2 rays, max_steps {problem.max_steps}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    adam = functools.partial(torch.optim.Adam, lr=SET_LR)
    runs, k3_launches, k4_launches = {}, 0, 0
    for n_brick, n_ray in ((1, 1), (2, 2)):
        mesh = logical_mesh(dev, n_brick, n_ray)
        state = init_state(start, grayscale_ramp(), adam, mesh=mesh)
        step = make_train_step(start, adam, mesh)
        losses, at, first = [], [], None
        torch.cuda.synchronize()
        exact.march_exact.launches = exact.march_exact_backward.launches = 0
        n_leaves = sum(len(g["params"]) for g in state.optimizer.param_groups)
        with captured(exact, "march_exact_backward") as calls, adam_counted(
                f"exact set trainer ({n_ray}x{n_brick})", n_leaves * SET_STEPS):
            t_start = time.perf_counter()
            for i in range(SET_STEPS):
                losses.append(float(step(state, eye, dirs, tnp, target)))  # synchronises
                at.append(time.perf_counter())
                if i == 0:
                    first = (torch.cat([d.grad for d in state.params["density"]]).clone(),
                             state.params["tf"].grad.clone())
        counts = (exact.march_exact.launches, exact.march_exact_backward.launches)
        # ------------------------------------------ end of this mesh's main path
        want = (SET_STEPS * n_brick * n_ray,) * 2
        if counts != want:
            raise AssertionError(f"the {n_ray}x{n_brick} exact trainer launched K3 and K4 "
                                 f"{counts} times, want {want}")
        k3_launches += counts[0]
        k4_launches += counts[1]
        steps_ms = np.diff([t_start] + at) * 1e3
        step_ms = float(np.median(steps_ms[1:]))
        print(f"exact set trainer on a {n_ray}x{n_brick} mesh: {SET_STEPS} Adam steps (lr "
              f"{SET_LR}): losses {losses}; step median of steps 2-{SET_STEPS} {step_ms:.3f} ms "
              f"(all {', '.join(f'{x:.3f}' for x in steps_ms)} ms, host clock); K3 "
              f"{counts[0]}, K4 {counts[1]} launches {card}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"the exact set trainer's loss did not fall: {losses}")
        runs[(n_brick, n_ray)] = dict(losses=losses, first=first, step_ms=step_ms,
                                      call=calls[-1])
        del state, step
    one, four = runs[(1, 1)], runs[(2, 2)]
    l1, l4 = one["losses"][0], four["losses"][0]
    print(f"exact set trainer, 2x2 vs 1x1, first step: loss {l4!r} vs {l1!r} (relative "
          f"{abs(l4 - l1) / abs(l1):.3e})")
    if abs(l4 - l1) > SHARD_LOSS_RTOL * abs(l1):
        raise AssertionError(f"the 2x2 exact set trainer's loss {l4} is off the 1x1's {l1}")
    for name, a, b in zip(("d_density", "d_tf"), four["first"], one["first"]):
        compare_grads(a, b, f"exact set trainer, 2x2 vs 1x1, first step: {name}", 1.1,
                      EXACT_GRAD_TOL_MAX)

    # VolumeScene over the same set with the exit on: target, forward, backward.
    scene = VolumeScene(bricks=sharded, tf=tf_true, global_min=gmin, global_max=gmax,
                        params=RenderParams(data_source_range=(0.0, 1.0),
                                            filter_mode="trilinear"))
    if scene.params.early_exit != SCENE_EXIT:
        raise AssertionError(f"the scene's early exit is {scene.params.early_exit}")
    leaves = {"density": (0.5 * sharded.data + 0.25).requires_grad_(),
              "tf": tf_true.clone().requires_grad_()}
    torch.cuda.synchronize()
    exact.march_exact.launches = exact.march_exact_backward.launches = 0
    with captured(exact, "march_exact_backward") as scene_calls:
        t_scene = time.perf_counter()
        with torch.no_grad():
            scene_target = scene.render(camera)
        img = scene.with_parameters(leaves).render(camera)
        loss = torch.mean((img - scene_target) ** 2)
        loss.backward()
        scene_loss = float(loss.detach())  # synchronises
        scene_ms = (time.perf_counter() - t_scene) * 1e3
    scene_counts = (exact.march_exact.launches, exact.march_exact_backward.launches)
    # --------------------------------------------- end of the scene's main path
    exits = int((img.detach()[..., 3] > SCENE_EXIT).sum())
    print(f"VolumeScene over {sharded.num_bricks} bricks, early exit {SCENE_EXIT}: target, "
          f"forward and backward {scene_ms:.3f} ms (host clock, first call); loss "
          f"{scene_loss:.6f}; {exits} of {img.shape[0] * img.shape[1]} rays exit; K3 "
          f"{scene_counts[0]}, K4 {scene_counts[1]} launches {card}")
    if scene_counts != (2, 1):
        raise AssertionError(f"the set scene launched K3 and K4 {scene_counts} times")
    if exits == 0 or not np.isfinite(scene_loss):
        raise AssertionError("the set scene's exit did not fire or its loss is not finite")
    for k, v in leaves.items():
        if not bool(torch.isfinite(v.grad).all()) or float(v.grad.abs().max()) == 0.0:
            raise AssertionError(f"the set scene's {k} gradient is not finite and non-zero")
    k3_launches += scene_counts[0]
    k4_launches += scene_counts[1]
    del img, scene_target, leaves

    # Off the main path: each K4 site timed and against plain on a window.
    sites, k4_err = [], 0.0
    for seed, (what, call, launches) in enumerate((
            ("the 1x1 exact set trainer", one["call"], SET_STEPS),
            ("one shard of the 2x2 exact set trainer", four["call"], 4 * SET_STEPS),
            ("VolumeScene over the set, exit on", scene_calls[-1], 1))):
        what = f"{what} ({call[0][0].shape[0]} bricks)"
        ms, b = k4_set_site(call, what, card)
        k4_err = max(k4_err, k4_set_window(call, what, seed))
        sites.append(("K4", f"RenderMarcherDiff backward over a set, {what}", launches, ms, b))
    (volume, tf, view, _o, _g), _kw = one["call"]
    volume, tf = volume.detach(), tf.detach()
    lo = (SCENE_RAYS - SUBSET) // 2
    pack = view.ray_pack.reshape(8, SCENE_RAYS, SCENE_RAYS)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    win = dataclasses.replace(view, ray_pack=pack.reshape(8, -1).contiguous(), width=SUBSET)
    slots = torch.arange(volume.shape[0], dtype=torch.int32, device=dev)
    march = (volume, slots, win.brick_boxes, tf, win.ray_pack,
             torch.zeros((win.n_rays, 4), device=dev), win.eye, win.params)
    k3_err = compare(exact.march_exact(*march, max_steps=win.max_steps, width=SUBSET),
                     exact.march_exact_reference(*march, max_steps=win.max_steps),
                     f"K3 over the set, the 1x1 exact set trainer, {SUBSET}x{SUBSET} window",
                     exact_tol)
    print(f"phase 30: {time.perf_counter() - t0:.1f} s")
    return dict(k3_launches=k3_launches, k4_launches=k4_launches, k3_err=k3_err,
                k4_err=k4_err, sites=sites,
                step_ms={"1x1": one["step_ms"], "2x2": four["step_ms"]})


# ------------------------------------------------------------------ phase 31
# Phase 31: K3 and K4 through their runtime-T instances, shared (T <= 4096)
# and global (past it: a 65 536-entry TF is what a .1dt file of a uint16
# volume's value range holds).
FINISH_TF_SIZES = (1, 32, 1024, 4096, 8192, 65536)
FINISH_TRAIN_TF = 32  # the exact trainer's TF in phase 31, as the JAX trainer's tests and dry run
FINISH_STEPS = 5
FINISH_WIDE_TF = 8192  # a TF past the shared instances: trainer steps and one xla frame
FINISH_WIDE_STEPS = 2
WALL_FRAMES = 2  # timed frames of each wall layout and its sequential loop, after one warm-up
WALL_REQUESTS = 3  # 2x2 service requests through the wall and through the loop (the first cold)


def run_script(module, argv, card, root):
    """``python -m libre_tpu_torch.benchmarks.<module> argv`` in a process
    of its own, with its wall time → (its render kernels' launch counts,
    its checks' largest errors, its standard output's lines); raises if it
    exits non-zero, ends without those two lines or launched a kernel it
    did not check."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"libre_tpu_torch.benchmarks.{module}", *argv],
                          cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    print(f"{module} {' '.join(argv)}: exit {proc.returncode}, {wall:.1f} s wall {card}")
    lines = proc.stdout.strip().splitlines()
    for line in proc.stderr.strip().splitlines()[-8:] + lines[-12:]:
        print(f"  | {line}")
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}")
    err_line, last = lines[-2:]
    if not (err_line.startswith("max_abs_err ") and last.startswith("launches ")):
        raise AssertionError(f"{module}: no checks' errors and launch counts at its end")
    checked = json.loads(err_line[len("max_abs_err "):])
    launches = json.loads(last[len("launches "):])
    for kernel, n in launches.items():
        if n and kernel not in checked:
            raise AssertionError(f"{module} launched {kernel} and never checked it")
    return launches, checked, lines


def phase_finish(dev, card, exact_tol, view, engine, pose, dense, serve_2x2_ms, size=512):
    """31. What finished the one-card port: K3 and K4 at any TF size, the
    multi-view wall, the bf16 resample of K1 and K5.

    Checks first: K3 and K4 through their runtime-T instances at T in
    ``FINISH_TF_SIZES`` against their plain versions on a ``SUBSET`` x
    ``SUBSET`` window of phase 13's training view 0 over its 512^3 smooth
    truth (the tolerances of phases 10 and 13; at T = 1 the density
    gradient is zero in both), and the whole view's K3 and K4 timed at
    those T beside the T = 256 fixed instances.  Then the main path, with
    the five render kernels' counts set to 0 just before and read just
    after: 5 Adam steps of the exact trainer from a 32-entry TF on view 0;
    the 1x2 and 2x2 walls of ``RenderService`` at 512x512 on phase 20's
    volume and screen-space error, ``render_wall`` against the sequential
    ``render_bricked`` loop (frame ms, host clock, ending in a
    synchronise); ``WALL_REQUESTS`` 2x2 requests over HTTP through the
    wall and as many through the loop; the bf16 store frame
    (``render_store_frame``) on phase 4's last pose and the bf16 dense
    frame (``render_frame``) on phase 16's.  Then: every wall tile and
    every wall-served canvas bit-equal to the loop's frames, the bf16
    launches bit-equal to their plain versions (``compute_dtype=
    "bfloat16"``), their ms beside the f32 instances' and each bf16 frame's
    distance from its f32 frame; ``benchmarks/demo_wall`` at its defaults
    in a process of its own.  Returns the phase's launches and largest
    errors by kernel."""
    import urllib.request

    import torch

    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import _kernels, exact
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.render.registry import create_renderer
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.testing import smooth_volume, tf_of_size
    from libre_tpu_torch.train import init_exact_state, make_exact_train_step

    t_phase = time.perf_counter()
    errs = dict.fromkeys(("post_sweep", "exact_march", "exact_march_bwd", "pre_sweep"), 0.0)
    gt = smooth_volume(EXACT_TRAIN_N, seed=7, device=dev)
    side = view.width  # the view's rays are side x side
    lo = (side - SUBSET) // 2
    sub = view.ray_pack.reshape(8, side, side)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    win = dataclasses.replace(view, ray_pack=sub.reshape(8, -1).contiguous(), width=SUBSET)
    slot = torch.zeros(1, dtype=torch.int32, device=dev)
    g = torch.randn((view.n_rays, 4), generator=torch.Generator().manual_seed(0)).to(dev)
    g_win = g.reshape(side, side, 4)[lo:lo + SUBSET, lo:lo + SUBSET].reshape(-1, 4).contiguous()

    def k3_args(tf, v):
        return (gt[None], slot, v.brick_boxes, tf, v.ray_pack,
                torch.zeros((v.n_rays, 4), device=dev), v.eye, v.params)

    samples = torch.zeros(view.n_rays, dtype=torch.int32, device=dev)
    exact.march_exact(*k3_args(torch.from_numpy(tf_of_size(256)).to(dev), view),
                      max_steps=view.max_steps, width=view.width, samples=samples)
    n_samples = int(samples.sum())  # the same at every T: the exit is off
    one = torch.ones(1, dtype=torch.int32)
    times, bounds, plain_ms, inst_errs = {}, {}, {}, {}
    for n_tf in (256,) + FINISH_TF_SIZES:
        kind = exact.tf_instance(n_tf)
        tf = torch.from_numpy(tf_of_size(n_tf)).to(dev)
        if n_tf != 256:
            what = f"T = {n_tf}, {SUBSET}x{SUBSET} window of training view 0"
            out_w = exact.march_exact(*k3_args(tf, win), max_steps=win.max_steps, width=SUBSET)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want_w = exact.march_exact_reference(*k3_args(tf, win), max_steps=win.max_steps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            k3_err = compare(out_w, want_w, f"K3, {what}", exact_tol)
            got = exact.march_exact_backward(gt, tf, win, out_w, g_win)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            want = exact.march_exact_backward_reference(gt, tf, win, out_w, g_win)
            torch.cuda.synchronize()
            plain_ms[n_tf] = ((t1 - t0) * 1e3, (time.perf_counter() - t2) * 1e3)
            k4_err = 0.0
            for name, a, b in zip(("d_volume", "d_tf"), got, want):
                compare_grads(a, b, f"K4, {what}: {name}", 1.1, EXACT_GRAD_TOL_MAX,
                              expect_zero=n_tf == 1 and name == "d_volume")
                k4_err = max(k4_err, float((a - b).abs().max()))
            errs["exact_march"] = max(errs["exact_march"], k3_err)
            errs["exact_march_bwd"] = max(errs["exact_march_bwd"], k4_err)
            old = inst_errs.get(kind, (0.0, 0.0))
            inst_errs[kind] = (max(old[0], k3_err), max(old[1], k4_err))
        fwd = k3_args(tf, view)
        out = exact.march_exact(*fwd, max_steps=view.max_steps, width=view.width)
        times[n_tf] = (
            cuda_ms(lambda: exact.march_exact(*fwd, max_steps=view.max_steps, width=view.width),
                    reps=10),
            cuda_ms(lambda: exact.march_exact_backward(gt, tf, view, out, g), reps=5, warmup=1),
        )
        bounds[n_tf] = (
            k3_bound_of(samples, one, gt.numel() * 4, 1, view.n_rays, "trilinear", True, n_tf),
            k4_bound_of(gt.numel(), view.n_rays, n_samples, "trilinear", True, n_tf),
        )
        print(f"  training view 0 over the {EXACT_TRAIN_N}^3 truth, T = {n_tf} ({kind} "
              f"instances): K3 {times[n_tf][0]:.4f} ms (bound {bounds[n_tf][0][0]:.4f} ms, "
              f"{bounds[n_tf][0][1]}), K4 {times[n_tf][1]:.4f} ms (TF gradient on, d_volume "
              f"zeroing included; bound {bounds[n_tf][1][0]:.4f} ms, {bounds[n_tf][1][1]}) "
              f"{card}")
        del fwd, out

    # The main path's set-up: the trainer's target and state, the service.
    tf32 = torch.from_numpy(tf_of_size(FINISH_TRAIN_TF)).to(dev)
    tf_wide = torch.from_numpy(tf_of_size(FINISH_WIDE_TF)).to(dev)
    with torch.no_grad():
        target = exact.render_exact_diff(gt, tf32, view)
        target_wide = exact.render_exact_diff(gt, tf_wide, view)
    state = init_exact_state(torch.full(gt.shape, 0.5, device=dev), tf32,
                             lambda p: torch.optim.Adam(p, lr=5e-2), device=dev)
    state_wide = init_exact_state(torch.full(gt.shape, 0.5, device=dev), tf_wide,
                                  lambda p: torch.optim.Adam(p, lr=5e-2), device=dev)
    train_step = make_exact_train_step(view)
    svc = RenderService(URI, width=size, height=size, host="127.0.0.1", port=0, device=dev)
    seng = svc.engine
    canvases, real_frame, real_plan = [], svc.render_frame, seng.plan_wall

    def render_frame(progressive=False):
        canvases.append(real_frame(progressive))
        return canvases[-1]

    def loop_only(*args, **kwargs):  # the wall's test made to fail: the sequential loop
        return [], "timed as the sequential loop"

    svc.render_frame = render_frame
    svc.server.start()
    host, port = svc.server.address
    base = f"http://{host}:{port}"

    def call(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.read()

    def frame_ms(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    half = np.asarray(engine.info.world_size, np.float32) * 0.5
    camera, frustum = pose
    tf_engine = engine.transfer_function

    def store_frame(compute_dtype):
        """Phase 4's last pose through ``render_store_frame`` on the
        engine's cached store, in ``compute_dtype``."""
        nodes = engine.select(frustum, camera.viewport[3], SERVE_SSE)
        params, swp, sw_plan, level, _dims = engine._store_view(camera, nodes, None, None)
        key = (sw_plan.axis, tuple(sorted(n.id for n in nodes)), 0, params.data_source_range,
               level)
        store, content, plan = engine._cached_store(key, nodes, sw_plan.axis, params, level)
        return swb.render_store_frame(
            store, plan, engine.transfer_function, camera, params=params,
            swp=dataclasses.replace(swp, compute_dtype=compute_dtype), world_min=-half,
            world_max=half, content=content)

    def dense_frame(compute_dtype):
        pa = dataclasses.replace(dense["pa"], swp=dataclasses.replace(
            dense["pa"].swp, compute_dtype=compute_dtype))
        chans = dense["chans"]
        return swd.render_frame(chans, chans.shape[1], chans.shape[2], dense["camera"], pa,
                                dense["content"])

    walls = {}
    try:
        call("/params", "PUT", {"synchronous": True, "sse": SERVE_SSE})
        torch.cuda.synchronize()
        counts = (swb.post_sweep, swg.store_grid_backward, exact.march_exact,
                  exact.march_exact_backward, swd.pre_sweep)
        for wrapper in counts:
            wrapper.launches = 0
        for wrapper in counts[2:4]:
            wrapper.instance_launches = dict.fromkeys(exact.TF_INSTANCES, 0)
        with adam_counted("exact trainer, 32- and 8192-entry TFs",
                          2 * (FINISH_STEPS + FINISH_WIDE_STEPS)):
            losses = [float(train_step(state, target)) for _ in range(FINISH_STEPS)]
            losses_wide = [float(train_step(state_wide, target_wide))
                           for _ in range(FINISH_WIDE_STEPS)]
        engine.transfer_function = tf_wide
        try:
            with captured(exact, "march_exact") as xla_calls:
                xla_frame = create_renderer("xla").render(engine, camera, frustum,
                                                          screen_space_error=SERVE_SSE)
        finally:
            engine.transfer_function = tf_engine
        for layout in ("1x2", "2x2"):
            svc.layout = layout
            kw = {k: v for k, v in svc.frame_keywords().items() if k != "synchronous"}
            views = [(*svc.view_camera(vw, vh, az), (dx, dy))
                     for dx, dy, vw, vh, az in svc._layout_views()]

            def wall():
                return seng.render_wall(views, (size, size), **kw)[0]

            def loop():
                return [seng.render_bricked(c, f, **kw)[0] for c, f, _off in views]

            runs = {"wall": [], "loop": []}
            for _ in range(1 + WALL_FRAMES):
                for name, fn in (("wall", wall), ("loop", loop)):
                    runs[name].append(frame_ms(fn))
            walls[layout] = dict(views=views, runs=runs)
        call("/layout", "PUT", {"name": "2x2"})
        latency = {"wall": [], "loop": []}
        for name in ("wall", "loop"):
            seng.plan_wall = real_plan if name == "wall" else loop_only
            for _ in range(WALL_REQUESTS):
                t0 = time.perf_counter()
                jpeg = call("/image-jpeg", "POST", {})
                latency[name].append((time.perf_counter() - t0) * 1e3)
                if jpeg[:2] != b"\xff\xd8":
                    raise AssertionError("phase 31: /image-jpeg gave no JPEG")
        seng.plan_wall = real_plan
        with Recorder("post_sweep") as k1_rec:
            store_f32 = store_frame("float32")
            store_bf16 = store_frame("bfloat16")
        with Recorder("pre_sweep") as k5_rec:
            dense_f32 = dense_frame("float32")
            dense_bf16 = dense_frame("bfloat16")
        torch.cuda.synchronize()
        launches = dict(zip(("post_sweep", "store_grid_bwd", "exact_march", "exact_march_bwd",
                             "pre_sweep"), (w.launches for w in counts)))
        instances = {name: dict(w.instance_launches)
                     for name, w in (("exact_march", counts[2]), ("exact_march_bwd", counts[3]))}
        # ----------------------------------------------- end of phase 31's main path
    finally:
        seng.plan_wall = real_plan
        svc.render_frame = real_frame
        svc.server.stop()

    base, _ = engine.render_bricked(camera, frustum, screen_space_error=SERVE_SSE)
    if not torch.equal(base, store_f32):
        raise AssertionError("render_store_frame's f32 frame is not the engine's frame")
    print(f"phase 31 main path launches: {launches}")
    n_wall_views = sum(2 * len(w["views"]) * (1 + WALL_FRAMES) for w in walls.values())
    n_steps = FINISH_STEPS + FINISH_WIDE_STEPS
    want = {"exact_march": n_steps + len(xla_calls), "exact_march_bwd": n_steps,
            "store_grid_bwd": 0, "post_sweep": n_wall_views + 2 * 4 * WALL_REQUESTS + 2,
            "pre_sweep": 2}
    if launches != want or not xla_calls:
        raise AssertionError(f"phase 31 launched {launches}, expected {want}")
    want_inst = {
        "exact_march": {"fixed": 0, "shared": FINISH_STEPS,
                        "global": FINISH_WIDE_STEPS + len(xla_calls)},
        "exact_march_bwd": {"fixed": 0, "shared": FINISH_STEPS, "global": FINISH_WIDE_STEPS},
    }
    print(f"phase 31 main path launches by instance: {instances}")
    if instances != want_inst:
        raise AssertionError(f"phase 31 launched the instances {instances}, expected {want_inst}")
    for n_tf, ls, st in ((FINISH_TRAIN_TF, losses, state), (FINISH_WIDE_TF, losses_wide,
                                                          state_wide)):
        print(f"exact trainer from a {n_tf}-entry TF ({exact.tf_instance(n_tf)} K3 and K4 "
              f"instances), view 0, {len(ls)} Adam steps: losses {ls}")
        if not all(np.isfinite(ls)) or not ls[-1] < ls[0]:
            raise AssertionError(f"the T = {n_tf} trainer did not lower its loss: {ls}")
        if st.params["tf"].shape != (n_tf, 4):
            raise AssertionError(f"the trainer's TF is {tuple(st.params['tf'].shape)}")
    # The xla frame from the wide TF: K3 (global instance) vs plain on a
    # window of its first pass's rays.
    (xargs, xkw), = xla_calls[:1]
    side_x = camera.viewport[2]
    lo_x = (side_x - SUBSET) // 2
    pack = xargs[4].reshape(8, -1, side_x)[:, lo_x:lo_x + SUBSET, lo_x:lo_x + SUBSET]
    sub_args = (*xargs[:4], pack.reshape(8, -1).contiguous(),
                xargs[5].reshape(-1, side_x, 4)[lo_x:lo_x + SUBSET, lo_x:lo_x + SUBSET]
                .reshape(-1, 4).contiguous(), *xargs[6:])
    got = exact.march_exact(*sub_args, max_steps=xkw["max_steps"], width=SUBSET)
    want_x = exact.march_exact_reference(*sub_args, max_steps=xkw["max_steps"])
    torch.cuda.synchronize()
    xla_err = compare(got, want_x, f"K3 of the xla frame from a {FINISH_WIDE_TF}-entry TF, "
                                   f"{SUBSET}x{SUBSET} window of its first pass", exact_tol)
    errs["exact_march"] = max(errs["exact_march"], xla_err)
    inst_errs["global"] = (max(inst_errs["global"][0], xla_err), inst_errs["global"][1])
    if not (bool(torch.isfinite(xla_frame).all()) and tuple(xla_frame.shape) == (size, size, 4)
            and float(xla_frame[..., 3].max()) > 0.1):
        raise AssertionError(f"the xla frame from a {FINISH_WIDE_TF}-entry TF is wrong")
    print(f"xla frame from a {FINISH_WIDE_TF}-entry TF at {size}x{size} (sse {SERVE_SSE}): "
          f"{len(xla_calls)} K3 launches (global instance), its window {xla_err:.3e} from plain")
    print(f"K3 / K4 on the whole of view 0 by T (ms; T = 256 the fixed instances) {card}: "
          + "; ".join(f"T = {t} {times[t][0]:.4f} / {times[t][1]:.4f}" for t in sorted(times)))
    for t in (4096, 8192, 65536):
        print(f"  T = {t} against T = 256: K3 {times[t][0] / times[256][0] - 1:+.1%}, "
              f"K4 {times[t][1] / times[256][1] - 1:+.1%}")

    for layout, w in walls.items():
        wall_canvas = w["runs"]["wall"][-1][1]
        seq = w["runs"]["loop"][-1][1]
        parity = 0.0
        for (cam, _fr, (dx, dy)), img in zip(w["views"], seq):
            vw, vh = cam.viewport[2:]
            parity = max(parity, float((wall_canvas[dy:dy + vh, dx:dx + vw] - img).abs().max()))
        if parity != 0.0:
            raise AssertionError(f"the {layout} wall's tiles are {parity} from the loop's frames")
        wall_ms = [ms for ms, _ in w["runs"]["wall"][1:]]
        loop_ms = [ms for ms, _ in w["runs"]["loop"][1:]]
        print(f"wall {layout} at {size}x{size} (sse {SERVE_SSE}): render_wall {wall_ms} ms a frame, "
              f"the sequential loop {loop_ms} ms (first frames {w['runs']['wall'][0][0]:.3f} / "
              f"{w['runs']['loop'][0][0]:.3f} ms); tiles vs the loop's frames max|d| {parity} "
              f"{card}")
    served_wall = canvases[:WALL_REQUESTS]
    served_loop = canvases[WALL_REQUESTS:]
    if len(canvases) != 2 * WALL_REQUESTS or any(
            not np.array_equal(a, b) for a, b in zip(served_wall, served_loop)):
        raise AssertionError("the service's wall canvas differs from its sequential canvas")
    print(f"service 2x2 request latency (POST /image-jpeg, {size}x{size}): through the wall "
          f"{[round(x, 3) for x in latency['wall']]} ms, through the loop "
          f"{[round(x, 3) for x in latency['loop']]} ms (phase 20's 2x2 request, through the "
          f"wall: {serve_2x2_ms:.3f} ms); served canvases bit-equal {card}")

    bf16_sites(k1_rec.calls, k5_rec.calls, card)
    store_gap = float((store_bf16 - store_f32).abs().max())
    dense_gap = float((dense_bf16 - dense_f32).abs().max())
    print(f"bf16 frame vs f32 frame, max|d|: store frame (K1) {store_gap:.3e}, dense frame (K5) "
          f"{dense_gap:.3e}")
    if not (0.0 < store_gap < 0.1 and 0.0 < dense_gap < 0.1):
        raise AssertionError(f"bf16 frames {store_gap}, {dense_gap} from the f32 frames")

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        demo_launches, demo_errs, lines = run_script(
            "demo_wall", ["--out", os.path.join(tmp, "wall_run.json")], card, root)
    record = json.loads(lines[-3])
    for layout in ("1x2", "2x2"):
        if record[layout]["tile_parity_max_abs"] != 0.0:
            raise AssertionError(f"demo_wall {layout}: tiles off the sequential frames")
    for kernel, n in demo_launches.items():
        launches[kernel] = launches.get(kernel, 0) + n
    for kernel, err in demo_errs.items():
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    del gt, state, target, state_wide, target_wide, svc, seng
    free_device_memory()
    # The kernels line's entries of K3's and K4's runtime-T instances: the
    # main path's launches of each; times on training view 0 at T = 1024
    # (shared) and 8192 (global), the plain versions' on the window.
    instance_entries = []
    for kind, n_tf, label in (("shared", 1024, "shared (T <= 4096, T != 256)"),
                              ("global", FINISH_WIDE_TF, "global (T > 4096)")):
        for i, (name, src, replaces) in enumerate((
                ("exact_march", "exact_march.cu", "libre_tpu/ops/exact_pallas.py:481"),
                ("exact_march_bwd", "exact_march_bwd.cu", "libre_tpu/ops/exact_pallas.py:1405"))):
            instance_entries.append({
                "name": name, "instance": f"{label}, T = {n_tf}", "route": "cuda",
                "source": f"libre_tpu_torch/csrc/{src}", "replaces": replaces,
                "launches": instances[name][kind], "max_abs_err": inst_errs[kind][i],
                "ms": times[n_tf][i], "plain_ms": plain_ms[n_tf][i],
                "bound_ms": bounds[n_tf][i][0], "bound_by": bounds[n_tf][i][1],
                "library_ms": None,
            })
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s")
    return launches, errs, instance_entries


def phase_adam(dev, card, n=512, steps=5, reps=20):
    """32. The trainers' update at full width: one Adam step of an n^3 leaf
    and a (256, 4) TF through ``step_optimizer`` (the kernel, one launch
    a leaf), for each epilogue (the exact trainer's density "none", the
    dense volume "clamp01", the store "pin" over a store whose first
    eighth is SENTINEL), against ``torch.optim.Adam``'s foreach step and
    the old epilogue as separate passes over ``steps`` steps (launches
    counted from 0, no fallback); then, with a count of its own, the
    kernel timed (CUDA events, ``reps`` launches) on the n^3 leaf beside
    its bound, ``step_optimizer`` over the leaf and the TF beside the
    foreach step and the old epilogue (the path the kernel replaced),
    torch's fused Adam (``fused=True``, one multi-tensor pass of 28 B a
    value) over the leaf with the epilogue in place (the pin by a
    coverage mask, ``clamp_`` and ``masked_fill_``), and the plain
    version.  Returns the ``kernels`` line's entry (the pin's numbers, the
    fused Adam with the pin as ``library_ms``, the launches of every
    counted main path, ``ADAM_RUNS``) and each epilogue's (ms, bound) on
    the n^3 leaf."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops.adam import EPILOGUES, adam_update
    from libre_tpu_torch.testing import ADAM_TOL_ULPS
    from libre_tpu_torch.train.update import separate_passes, step_optimizer

    def epilogues(leaves, epilogue):
        pin = [leaves[0]] if epilogue == "pin" else []
        return pin, [leaves[1]] + ([leaves[0]] if epilogue == "clamp01" else [])

    unit = 2.0**-23
    gen = torch.Generator(device=dev).manual_seed(21)
    n_values = n**3
    b_ms, b_by = bound(ADAM_BYTES_PER_VALUE * n_values, ADAM_OPS_PER_VALUE * n_values)
    rows, gap = {}, 0.0
    for epilogue in EPILOGUES:
        start = torch.rand((n, n, n), device=dev, generator=gen)
        if epilogue == "pin":
            start[:, :, : n // 8] = swb.SENTINEL
        tf0 = torch.rand((256, 4), device=dev, generator=gen)
        got = [start.clone().requires_grad_(), tf0.clone().requires_grad_()]
        want = [start.clone().requires_grad_(), tf0.clone().requires_grad_()]
        opt_got, opt_want = torch.optim.Adam(got, lr=3e-2), torch.optim.Adam(want, lr=3e-2)
        with adam_counted(f"phase 32's checked steps ({epilogue}, {n}^3 and the TF)", 2 * steps):
            for _ in range(steps):
                for a, b in zip(got, want):
                    b.grad = torch.randn(a.shape, device=dev, generator=gen)
                    a.grad = b.grad.clone()
                step_optimizer(opt_got, **dict(zip(("pin", "clamp"), epilogues(got, epilogue))))
                separate_passes(opt_want, *epilogues(want, epilogue))
        torch.cuda.synchronize()
        errs = []
        for a, b in zip(got, want):
            pairs = [(a.detach(), b.detach(), 1.0)] + [
                (opt_got.state[a][k], opt_want.state[b][k], None)
                for k in ("exp_avg", "exp_avg_sq")]
            for x, y, floor in pairs:
                scale = float(y.abs().max()) if floor is None else floor
                errs.append(float(((x - y).abs() / (y.abs() + scale)).max()) / unit)
                gap = max(gap, float((x - y).abs().max()))
        if max(errs) > ADAM_TOL_ULPS:
            raise AssertionError(f"adam_update {epilogue}: {max(errs):.2f} ulps from torch")
        leaf, g = got[0].detach(), got[0].grad
        m, v = opt_got.state[got[0]]["exp_avg"], opt_got.state[got[0]]["exp_avg_sq"]
        kw = dict(step=steps + 1, lr=3e-2, betas=(0.9, 0.999), eps=1e-8, epilogue=epilogue)
        # Torch's fused Adam over a copy of the leaf, its gradient shared.
        lib = start.clone().requires_grad_()
        lib.grad = g
        fused = torch.optim.Adam([lib], lr=3e-2, fused=True)

        @torch.no_grad()
        def fused_step():
            uncovered = (lib > -0.5).logical_not_() if epilogue == "pin" else None
            fused.step()
            if epilogue != "none":
                lib.clamp_(0.0, 1.0)
            if uncovered is not None:
                lib.masked_fill_(uncovered, swb.SENTINEL)

        del start
        adam_update.launches = step_optimizer.fallbacks = 0
        ms = cuda_ms(lambda: adam_update(leaf, g, m, v, **kw), reps)
        ours_ms = cuda_ms(lambda: step_optimizer(
            opt_got, **dict(zip(("pin", "clamp"), epilogues(got, epilogue)))), reps)
        if step_optimizer.fallbacks:
            raise AssertionError(f"phase 32's timed steps fell back {step_optimizer.fallbacks} "
                                 "times")
        timed = adam_update.launches
        lib_ms = cuda_ms(lambda: separate_passes(opt_want, *epilogues(want, epilogue)), reps)
        fused_ms = cuda_ms(fused_step, reps)
        plain_ms = cuda_ms(lambda: adam_update.reference(leaf, g, m, v, **kw), 3, warmup=1)
        rows[epilogue] = (ms, ours_ms, lib_ms, fused_ms, plain_ms)
        print(f"adam_update {epilogue}: {max(errs):.2f} ulps from torch over {steps} steps "
              f"(largest absolute gap so far {gap:.3e}); "
              f"kernel {ms:.4f} ms on {n}^3 (bound {b_ms:.4f} ms, {b_by}; at {b_ms / ms:.3f} "
              f"of it); step_optimizer over the leaf and the TF {ours_ms:.4f} ms, "
              f"torch.optim.Adam (foreach) and the epilogue {lib_ms:.4f} ms; torch's fused "
              f"Adam and the epilogue in place over the leaf {fused_ms:.4f} ms (kernel ÷ fused "
              f"{ms / fused_ms:.3f}); plain {plain_ms:.4f} ms; {timed} timed launches, "
              f"counted apart {card}")
        del got, want, opt_got, opt_want, leaf, g, m, v, lib, fused
        free_device_memory()
    ms, _ours, _foreach, fused_ms, plain_ms = rows["pin"]
    return {
        "name": "adam_update",
        "route": "cuda",
        "source": "libre_tpu_torch/csrc/adam_update.cu",
        "replaces": None,
        "launches": sum(k for _, k in ADAM_RUNS),
        "max_abs_err": gap,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": fused_ms,
    }, {e: (r[0], (b_ms, b_by)) for e, r in rows.items()}


def bf16_sites(k1_calls, k5_calls, card):
    """Phase 31's recorded K1 and K5 launches, (f32, bf16) each: the bf16
    launches bit-equal to their plain versions (``compute_dtype=
    "bfloat16"``), then every launch timed on its operands."""
    import torch

    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_dense as swd

    (_, k1_f32), (_, k1_bf16) = k1_calls
    (_, k5_f32), (_, k5_bf16) = k5_calls
    ops, (out, t_out) = k1_operands(k1_bf16)
    work = k1_work(*ops)
    if not (torch.equal(out, work["want"]) and torch.equal(t_out, work["t_want"])):
        raise AssertionError("K1's bf16 instance is not bit-equal to the plain bf16 sweep")
    (chans, a0, a1, wa, dl, act, vvec, corr, out5, _k, _nc, _nb, _v, _u,
     wb0, wb1, wc0, wc1, _sb, _sc, early_exit, bf16) = k5_bf16
    tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=vvec, corr=corr,
                             rgb_in=None, t_in=None)
    want5 = swd.pre_sweep_reference(chans, tables, wb=(wb0, wb1), wc=(wc0, wc1),
                                    early_exit=early_exit, compute_dtype="bfloat16")
    if not (bf16 == 1 and torch.equal(out5, want5)):
        raise AssertionError("K5's bf16 instance is not bit-equal to the plain bf16 sweep")
    ms = {}
    for tag, name, args in (("K1 f32", "post_sweep", k1_f32), ("K1 bf16", "post_sweep", k1_bf16),
                            ("K5 f32", "pre_sweep", k5_f32), ("K5 bf16", "pre_sweep", k5_bf16)):
        ms[tag] = cuda_ms(lambda: _kernels.launch(name, *args), reps=20)
    print(f"bf16 resample on the main-path views: K1 {ms['K1 bf16']:.4f} ms against the f32 "
          f"instance's {ms['K1 f32']:.4f} ms (bound {work['bound'][0]:.4f} ms, "
          f"{work['bound'][1]}); K5 {ms['K5 bf16']:.4f} ms against {ms['K5 f32']:.4f} ms; both "
          f"bit-equal to their plain versions {card}")


def main() -> int:
    import torch

    from libre_tpu_torch.utils.profiling import StageTimers

    # ---------------------------------------------------------- 1. the card
    t_last = [time.perf_counter()]
    timers = StageTimers()  # each phase's seconds, reported at the end

    def phase_done(n, quiet=False):
        now = time.perf_counter()
        if not quiet:
            print(f"phase {n}: {now - t_last[0]:.1f} s")
        timers.totals[f"phase {n:02d}"] += now - t_last[0]
        timers.counts[f"phase {n:02d}"] += 1
        t_last[0] = now

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (sm_90a), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    card = f"[{smi}]"
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls must not run in TF32")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
    )

    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.testing import FIELDS, SWEEP_VIEWS, store_grad_case, sweep_case

    phase_done(1)
    # ------------------------------------------------------------- 2. build
    for name, secs in _kernels.build_all().items():
        print(f"build {name}: {secs:.2f} s ({_kernels.library_path(name).name})")

    phase_done(2)
    # ------------------------------------------- 3. kernel vs plain, seeded
    # Every view of SWEEP_VIEWS (on axis, the eye inside the volume, an
    # oblique one) at both shapes: K1 bit-equal to the plain sweep, and
    # its plane lists a superset of the planes each tile fetches at.
    for view in SWEEP_VIEWS:
        for shape in ((96, 80, 128, 64, 48, 56), (512, 512, 512, 512, 512, 512)):
            store, tf, tables, clip, kw = sweep_case(shape, seed=0, device=dev, view=view)
            got, t_got = swb.post_sweep(store, tf, tables, clip, **kw)
            work = k1_work(store, tf, tables, clip, kw)
            want, t_want, fetches = work["want"], work["t_want"], work["fetches"]
            lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
            torch.cuda.synchronize()
            what = f"seeded sweep {view} V,U,K,Na,Nc,Nb={shape}"
            compare(got, want, what)
            compare(t_got, t_want, f"seeded transmittance {view} {shape}")
            if not (torch.equal(got, want) and torch.equal(t_got, t_want)):
                raise AssertionError(f"{what}: K1 is not bit-equal to the plain sweep")
            if not bool((fetches <= lists).all()):
                raise AssertionError(f"{what}: a tile fetches at a plane off its list")
            saturated = float((got[..., 3] > 0.999).float().mean())
            print(f"  bit-equal; early exit reached by {saturated:.3f} of the rays; tiles list "
                  f"{int(lists.sum())} of {lists.numel()} (tile, plane) pairs and fetch at "
                  f"{int(fetches.sum())}")
            if view == "axis" and saturated == 0.0:
                raise AssertionError("the seeded case never fired the early exit")
            del store, tables, got, want, fetches, lists, work

    phase_done(3)
    # --------------------------------------------------------- 4. main path
    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.utils.image import read_image

    load_plugins()
    poses = orbit_cameras()
    swb.post_sweep.launches = 0
    swg.store_grid_backward.launches = 0
    with tempfile.TemporaryDirectory() as out_dir, Recorder("post_sweep") as k1_cli:
        t0 = time.perf_counter()
        rc = render_cli.main([
            "--volume", URI, "--width", "512", "--height", "512",
            "--output-dir", out_dir,
        ])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"render_cli exited {rc}")
        png = read_image(os.path.join(out_dir, "frame_000000.png"))
    cli_launches = swb.post_sweep.launches
    if png.shape[:2] != (512, 512) or png.max() == 0:
        raise AssertionError(f"render_cli image {png.shape}, max {png.max()}")

    engine = RenderEngine(DataSource(URI), device=dev)
    frames, frame_ms, stats = [], [], None
    for camera, frustum in poses:
        t0 = time.perf_counter()
        img, stats = engine.render_bricked(camera, frustum, screen_space_error=1.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        frames.append(img)
    launches = swb.post_sweep.launches
    render_bwd_launches = swg.store_grid_backward.launches
    # ------------------------------------------------- end of the main path

    if render_bwd_launches != 0:
        raise AssertionError(f"rendering launched the backward {render_bwd_launches} times")
    if cli_launches != 1 or launches != 1 + len(poses):
        raise AssertionError(
            f"post_sweep launched {cli_launches} times for the CLI frame and "
            f"{launches - cli_launches} for {len(poses)} orbit frames"
        )
    for i, img in enumerate(frames):
        if tuple(img.shape) != (512, 512, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"orbit frame {i}: {tuple(img.shape)} or non-finite")
        if float(img[..., 3].max()) <= 0.0:
            raise AssertionError(f"orbit frame {i} is empty")
    if len(engine._store_cache) != 1:
        raise AssertionError(
            f"orbit assembled {len(engine._store_cache)} stores, expected 1"
        )
    (store, content, plan), = [engine._store_cache.get(k) for k in list(engine._store_cache)]
    runner, = engine._frame_runners.values()
    print(
        f"main path: render level {plan.render_level}, {stats.n_available} bricks, "
        f"store {tuple(store.shape)} = {store.numel() * 4} B, "
        f"{launches} sweep launches for 1 CLI + {len(poses)} orbit frames"
    )
    print(f"render_cli 512x512 frame incl. data generation: {cli_s:.3f} s {card}")
    steady = sorted(frame_ms[1:])
    print(
        f"orbit first frame (bricks generated, uploaded, assembled): "
        f"{frame_ms[0]:.1f} ms; steady frames 2-{len(poses)}: median "
        f"{steady[len(steady) // 2]:.3f} ms, min {steady[0]:.3f} ms {card}"
    )

    # Steady-frame breakdown: host LOD selection vs the store frame
    # (view vector upload, sweep tables, sweep kernel, warp).
    camera, frustum = poses[-1]
    t0 = time.perf_counter()
    engine.select(frustum, 512, 1.0)
    select_ms = (time.perf_counter() - t0) * 1e3
    tf = engine.transfer_function
    t0 = time.perf_counter()
    runner(store, tf, camera)
    torch.cuda.synchronize()
    store_frame_ms = (time.perf_counter() - t0) * 1e3
    print(
        f"steady frame breakdown: select_visibles {select_ms:.3f} ms (host), "
        f"store frame {store_frame_ms:.3f} ms {card}"
    )

    phase_done(4)
    # -------------------------- 5. kernel vs plain at the main path's shape
    sw_plan = sw.make_view_plan(camera)
    fv = torch.from_numpy(runner.view_vector(camera, sw_plan)).to(dev)
    tables = swb.sweep_tables(
        fv, na=runner.na, k_planes=runner.k_planes, v_size=runner.v_size,
        u_size=runner.u_size, content=runner.content,
    )
    kw = dict(n_clip=runner.n_clip, wb=runner.wb, wc=runner.wc,
              early_exit=runner.early_exit)
    got, t_got = swb.post_sweep(store, tf, tables, runner.clip, **kw)
    work = k1_work(store, tf, tables, runner.clip, kw)
    want, t_want, samples, planes = work["want"], work["t_want"], work["samples"], work["planes"]
    fetches, k1_bound = work["fetches"], work["bound"]
    lists = swb.tile_planes_reference(tables, runner.wb, runner.wc)
    rows, cols = swb.SWEEP_TILE
    torch.cuda.synchronize()
    max_err = compare(got, want, "main-path sweep")
    if not (torch.equal(got, want) and torch.equal(t_got, t_want)):
        raise AssertionError("main-path sweep: K1 is not bit-equal to the plain sweep")
    if not bool((fetches <= lists).all()):
        raise AssertionError("main-path sweep: a tile fetches at a plane off its list")
    n_tiles = lists[..., 0].numel()
    print(
        f"  bit-equal; the {n_tiles} tiles of {rows}x{cols} rays list "
        f"{int(lists.sum()) / n_tiles:.1f} planes each on average (of {int(tables.act.sum())} "
        f"active), at most {int(lists.sum(dim=-1).max())}; they fetch at "
        f"{int(fetches.sum()) / n_tiles:.1f}"
    )
    del fetches, lists
    ms = cuda_ms(lambda: swb.post_sweep(store, tf, tables, runner.clip, **kw), reps=20)
    plain_ms = cuda_ms(
        lambda: swb.post_sweep_reference(store, tf, tables, runner.clip, **kw),
        reps=3, warmup=1,
    )
    # The work behind the kernel time: how many of the V·U·K plane
    # samples this view's rays really fetch (8 store loads each).
    n_rays = runner.v_size * runner.u_size
    n_grid = n_rays * runner.k_planes
    fetched = int(samples.sum())
    print(
        f"sweep at {runner.v_size}x{runner.u_size} rays x {runner.k_planes} planes "
        f"over {tuple(store.shape)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms {card}"
    )
    print(
        f"  this view's work: active planes {int(tables.act.sum())}/{runner.k_planes}, "
        f"rays that fetch a sample {float((samples > 0).float().mean()):.4f}, "
        f"rays ending in the early exit "
        f"{float(((1.0 - t_want) > runner.early_exit).float().mean()):.4f}, "
        f"samples fetched {fetched} of {n_grid} ({fetched / n_grid:.4f}), "
        f"mean {fetched / max(1, int((samples > 0).sum())):.1f} per fetching ray; "
        f"kernel {fetched / (ms * 1e-3) / 1e9:.3f} G samples/s {card}"
    )
    slices = torch.unique(torch.cat([tables.a0[planes], tables.a1[planes]]))
    _na, s_nc, s_nb = store.shape
    n_touched = work["touched"]
    print(
        f"  K1 bound: {n_touched} store voxels read ({n_touched / (slices.numel() * s_nc * s_nb):.4f} "
        f"of the {slices.numel()} slices of the {int(planes.sum())} planes fetched); "
        f"{k1_bound[0]:.4f} ms, {k1_bound[1]}-bound; kernel at {k1_bound[0] / ms:.4f} of it {card}"
    )
    del work
    # K1's launch sites on the main paths: (kernel, site, launches, ms per
    # launch on the site's operands, bound), printed with the kernels line.
    sites = [("K1", "StoreFrameRunner, orbit frames (sse 1)", launches - cli_launches, ms,
              k1_bound)]
    # The CLI frame's launch (sse 4), on the operands it was given.
    (_name, cli_args), = k1_cli.calls
    cli_ops, (cli_out, cli_t) = k1_operands(cli_args)
    cli_work = k1_work(*cli_ops)
    k1_cli_bound = cli_work["bound"]
    torch.cuda.synchronize()
    if not (torch.equal(cli_out, cli_work["want"]) and torch.equal(cli_t, cli_work["t_want"])):
        raise AssertionError("render_cli's sweep: K1 is not bit-equal to the plain sweep")
    k1_cli_ms = cuda_ms(lambda: _kernels.launch("post_sweep", *cli_args), reps=20)
    sites.insert(0, ("K1", "StoreFrameRunner, render_cli frame (sse 4)", cli_launches,
                     k1_cli_ms, k1_cli_bound))
    print(
        f"K1 on render_cli's operands (store {tuple(cli_ops[0].shape)}): {k1_cli_ms:.4f} ms, "
        f"bit-equal to plain; {int(cli_work['samples'].sum())} samples fetched; bound "
        f"{k1_cli_bound[0]:.4f} ms ({k1_cli_bound[1]}) {card}"
    )
    del cli_ops, cli_args, cli_out, cli_work, k1_cli

    from libre_tpu_torch.apps.render_cli import build_camera

    small = "mem://#64,64,64,16?pattern=gradient"
    camera, frustum = build_camera(48, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    on_card, _ = RenderEngine(DataSource(small), max_gpu_cache_mb=64, device=dev) \
        .render_bricked(camera, frustum, screen_space_error=1.0, n_planes=64)
    on_cpu, _ = RenderEngine(DataSource(small), max_gpu_cache_mb=64, device="cpu") \
        .render_bricked(camera, frustum, screen_space_error=1.0, n_planes=64)
    small_err = float((on_card.cpu() - on_cpu).abs().max())
    print(f"small volume, card vs CPU port: max|d| {small_err:.3e}")
    if small_err > SMALL_TOL_MAX or float(on_cpu[..., 3].max()) <= 0.0:
        raise AssertionError(f"card frame disagrees with the CPU port ({small_err})")

    phase_done(5)
    # ---------------------------- 6. backward kernel vs plain, seeded
    # Every field at 96x80 rays x 128 planes, the random one also at 512^3.
    k2_cases = [((96, 80, 128, 64, 48, 56), f) for f in FIELDS]
    k2_cases.append(((512, 512, 512, 512, 512, 512), "random"))
    for shape, field in k2_cases:
        for early_exit in (1.1, 0.999):
            store_s, tf_s, tables_s, out_s, t_s, g_s, kw_s = store_grad_case(
                shape, seed=0, device=dev, early_exit=early_exit, field=field
            )
            ds_ref, dtf_ref = swg.store_grid_backward_reference(
                store_s, tf_s, tables_s, out_s, t_s, g_s, diff_tf=True, **kw_s
            )
            for diff_tf in (True, False):
                ds, dtf = swg.store_grid_backward(
                    store_s, tf_s, tables_s, out_s, t_s, g_s, diff_tf=diff_tf, **kw_s
                )
                torch.cuda.synchronize()
                what = (f"seeded backward {shape} {field} early_exit={early_exit} "
                        f"diff_tf={diff_tf}")
                compare_grads(ds, ds_ref, f"{what}: d_store", early_exit)
                if diff_tf:
                    compare_grads(dtf, dtf_ref, f"{what}: dtf", early_exit)
                elif float(dtf.abs().max()) != 0.0:
                    raise AssertionError(f"{what}: dtf is not zero")
            saturated = float((out_s[..., 3] > 0.999).float().mean())
            print(f"  rays past alpha 0.999: {saturated:.3f}")
            if early_exit < 1.0 and saturated == 0.0:
                raise AssertionError("the seeded backward case never fired the early exit")
            del store_s, tables_s, out_s, ds, ds_ref

    phase_done(6)
    # ------------------------------------------------ 7. the training path
    from libre_tpu_torch.train import (
        StoreProblem,
        fit,
        restore_checkpoint,
        save_checkpoint,
    )
    from libre_tpu_torch.train.store_trainer import EARLY_EXIT_OFF, render_views

    chosen = poses[:: len(poses) // TRAIN_VIEWS][:TRAIN_VIEWS]
    plans = [sw.make_view_plan(cam, runner.slope_margin) for cam, _ in chosen]
    if {(p.axis, p.sign) for p in plans} != {(runner.axis, plans[0].sign)}:
        raise AssertionError("the training views do not share the store's axis and sign")
    views = np.stack([
        runner.view_vector(cam, p)[:11] for (cam, _), p in zip(chosen, plans)
    ])
    na, nc, nb = store.shape
    v_size, u_size = runner.v_size, runner.u_size
    problem = StoreProblem(
        views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=runner.k_planes, inter_size=(v_size, u_size),
        world_min=runner.wmin, world_max=runner.wmax, axis=runner.axis,
        diff_tf=True,
    )
    covered = store > -0.5
    init = torch.where(covered, 0.5, swb.SENTINEL)
    step_at = []

    def on_step(_i, _loss):
        step_at.append(time.perf_counter())  # the loss read synchronised

    swb.post_sweep.launches = 0
    swg.store_grid_backward.launches = 0
    with torch.no_grad():
        targets = render_views(problem, store, tf)
    if store.numel() != 512**3:  # the ranking's A1 site takes phase 32's 512^3 timing
        raise AssertionError(f"the training store {tuple(store.shape)} is not 512^3")
    t0 = time.perf_counter()
    with adam_counted(f"store trainer fit ({'x'.join(map(str, store.shape))} store, pin)",
                      2 * TRAIN_STEPS):
        params, losses = fit(
            problem, targets, init, tf, device=dev,
            optimizer=lambda p: torch.optim.Adam(p, lr=5e-2), steps=TRAIN_STEPS,
            on_step=on_step,
        )
    torch.cuda.synchronize()
    train_fwd_launches = swb.post_sweep.launches
    train_bwd_launches = swg.store_grid_backward.launches
    # ----------------------------------------- end of the training path

    print(f"training losses: {losses}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower the loss: {losses}")
    want_fwd = TRAIN_VIEWS * (1 + TRAIN_STEPS)
    want_bwd = TRAIN_VIEWS * TRAIN_STEPS
    if train_fwd_launches != want_fwd or train_bwd_launches != want_bwd:
        raise AssertionError(
            f"training launched the sweep {train_fwd_launches} times (want "
            f"{want_fwd}) and the backward {train_bwd_launches} (want {want_bwd})"
        )
    n_uncovered = int((~covered).sum())
    if not bool((params["store"][~covered] == swb.SENTINEL).all()):
        raise AssertionError("training moved uncovered (SENTINEL) voxels")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = os.path.join(ckpt_dir, "store.pt")
        save_checkpoint(path, params)
        restored = restore_checkpoint(path, device=dev)
    for k in params:
        if not torch.equal(restored[k], params[k].detach()):
            raise AssertionError(f"checkpoint round trip changed params[{k!r}]")
    steps_ms = np.diff([t0] + step_at) * 1e3
    step_ms = float(np.median(steps_ms[1:]))
    n_rays = TRAIN_VIEWS * v_size * u_size
    print(
        f"training: {TRAIN_VIEWS} views of {v_size}x{u_size} rays x "
        f"{runner.k_planes} planes over {tuple(store.shape)}, {n_uncovered} "
        f"uncovered voxels; sweep launches {train_fwd_launches}, backward "
        f"launches {train_bwd_launches}; checkpoint round trip equal"
    )
    print(
        f"training step: median of steps 2-{TRAIN_STEPS} {step_ms:.3f} ms "
        f"(all steps {', '.join(f'{x:.3f}' for x in steps_ms)} ms; step 1 includes "
        f"fit's set-up, where building the first torch.optim optimizer of the "
        f"process imports torch._dynamo); fwd+bwd "
        f"{n_rays / (step_ms * 1e-3) / 1e6:.3f} Mrays/s {card}"
    )

    # One view of the training path, kernel vs plain: the trained store and
    # TF, view 0's tables, the forward's out/t_out, and a seeded N(0, 1)
    # cotangent in place of the loss's (2(out - target)/n, ~1e-7 in size).
    p_store, p_tf = params["store"].detach(), params["tf"].detach()
    fv = torch.as_tensor(views[0]).to(dev)
    tables = swb.sweep_tables(
        fv, na=na, k_planes=runner.k_planes, v_size=v_size, u_size=u_size
    )
    clip0 = torch.zeros((swb.MAX_CLIP_PLANES, 4), device=dev)
    fwd_kw = dict(n_clip=0, wb=runner.wb, wc=runner.wc, early_exit=EARLY_EXIT_OFF)
    out, t_out = swb.post_sweep(p_store, p_tf, tables, clip0, **fwd_kw)
    gen = torch.Generator(device="cpu").manual_seed(0)
    g = torch.randn(out.shape, generator=gen).to(dev)
    bwd_kw = dict(wb=runner.wb, wc=runner.wc, early_exit=EARLY_EXIT_OFF, diff_tf=True)
    ds, dtf = swg.store_grid_backward(p_store, p_tf, tables, out, t_out, g, **bwd_kw)
    t1 = time.perf_counter()
    ds_ref, dtf_ref = swg.store_grid_backward_reference(
        p_store, p_tf, tables, out, t_out, g, **bwd_kw
    )
    torch.cuda.synchronize()
    bwd_plain_ms = (time.perf_counter() - t1) * 1e3
    compare_grads(ds, ds_ref, "training-view backward: d_store", EARLY_EXIT_OFF)
    compare_grads(dtf, dtf_ref, "training-view backward: dtf", EARLY_EXIT_OFF)
    bwd_err = float((ds - ds_ref).abs().max())
    del ds_ref
    fwd_ms = cuda_ms(lambda: swb.post_sweep(p_store, p_tf, tables, clip0, **fwd_kw), reps=10)
    # K1 on the training view: bit-equal to plain, and its bound.
    train_work = k1_work(p_store, p_tf, tables, clip0, fwd_kw)
    torch.cuda.synchronize()
    if not (torch.equal(out, train_work["want"]) and torch.equal(t_out, train_work["t_want"])):
        raise AssertionError("training view 0: K1 is not bit-equal to the plain sweep")
    rate("K1 on training view 0 (bit-equal to plain)", fwd_ms, int(train_work["samples"].sum()),
         train_work["bound"][0], card)
    sites.append(("K1", "RenderStoreGridDiff forward and render_views (store training)",
                  train_fwd_launches, fwd_ms, train_work["bound"]))
    del train_work
    in_box = []  # samples inside the box, per view: all fetched, no early exit
    for vs in views:
        tv = swb.sweep_tables(
            torch.as_tensor(vs).to(dev), na=na, k_planes=runner.k_planes,
            v_size=v_size, u_size=u_size,
        )
        ug = tv.view[0] + tv.view[1] * torch.arange(u_size, device=dev)
        vg = tv.view[5] + tv.view[2] * torch.arange(v_size, device=dev)
        xb = tv.view[3] + ug[None, :] * tv.dl[:, None]
        xc = tv.view[4] + vg[None, :] * tv.dl[:, None]
        in_u = ((xb >= runner.wb[0]) & (xb < runner.wb[1])).sum(1)
        in_v = ((xc >= runner.wc[0]) & (xc < runner.wc[1])).sum(1)
        in_box.append(int((in_u * in_v).sum()))
    n_grid = v_size * u_size * runner.k_planes
    print(
        f"samples inside the box per view (all fetched, early exit off), of "
        f"{n_grid}: {in_box} ({', '.join(f'{x / n_grid:.4f}' for x in in_box)})"
    )
    # K2's bound: the store read and d_store written once, out, t_out, g and
    # the per-ray tables read, the TF and dtf; every in-box sample's
    # operations (early exit off).  Without the TF gradient: no dtf and
    # none of the TF gradient's operations.
    k2_bytes = (2 * na * nc * nb * 4 + v_size * u_size * 15 * 4 + 2 * TF_BYTES
                + runner.k_planes * 5 * 4)
    k2_bound = bound(bytes_=k2_bytes, ops=in_box[0] * K2_OPS_PER_SAMPLE)
    k2_bound_no_tf = bound(bytes_=k2_bytes - TF_BYTES,
                           ops=in_box[0] * (K2_OPS_PER_SAMPLE - K2_TF_OPS_PER_SAMPLE))
    print(f"training view 0: sweep {fwd_ms:.3f} ms {card}")
    print(f"  K2 bound on view 0: {k2_bound[0]:.4f} ms, {k2_bound[1]}-bound; without the "
          f"TF gradient {k2_bound_no_tf[0]:.4f} ms, {k2_bound_no_tf[1]}-bound")
    # The same view over the truth store (the orbit's 512^3 gradient-pattern
    # store and the engine's TF: TF bins that differ from ray to ray and
    # move along each ray), kernel vs plain.
    out_t, t_out_t = swb.post_sweep(store, tf, tables, clip0, **fwd_kw)
    ds, dtf = swg.store_grid_backward(store, tf, tables, out_t, t_out_t, g, **bwd_kw)
    ds_ref, dtf_ref = swg.store_grid_backward_reference(
        store, tf, tables, out_t, t_out_t, g, **bwd_kw
    )
    torch.cuda.synchronize()
    compare_grads(ds, ds_ref, "truth-store backward, view 0: d_store", EARLY_EXIT_OFF)
    compare_grads(dtf, dtf_ref, "truth-store backward, view 0: dtf", EARLY_EXIT_OFF)
    bwd_err = max(bwd_err, float((ds - ds_ref).abs().max()))
    del ds, ds_ref
    k2_ms = {}  # (state, diff_tf) -> ms, incl. zeroing the 512 MiB d_store
    for state, operands in (("trained", (p_store, p_tf, tables, out, t_out)),
                            ("truth", (store, tf, tables, out_t, t_out_t))):
        for diff_tf in (True, False):
            k2_ms[state, diff_tf] = cuda_ms(
                lambda: swg.store_grid_backward(*operands, g, **dict(bwd_kw, diff_tf=diff_tf)),
                reps=5, warmup=1,
            )
            rate(f"K2 on view 0, {state} state, diff_tf={diff_tf}", k2_ms[state, diff_tf],
                 in_box[0], (k2_bound if diff_tf else k2_bound_no_tf)[0], card)
    bwd_ms = k2_ms["trained", True]
    print(
        f"training view 0: backward kernel {bwd_ms:.3f} ms (incl. zeroing the "
        f"{na * nc * nb * 4} B d_store; {k2_ms['trained', False]:.3f} ms without the TF "
        f"gradient; truth store {k2_ms['truth', True]:.3f} / {k2_ms['truth', False]:.3f} ms), "
        f"plain backward {bwd_plain_ms:.3f} ms (1 call) {card}"
    )
    del out_t, t_out_t

    phase_done(7)
    # ---------------------------------------- 8. K3 vs plain, seeded cases
    from libre_tpu_torch.ops import exact, raycast
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.testing import (
        EXACT_BRICK_VIEWS,
        EXACT_TOL_MAX,
        EXACT_TOL_MEAN,
        exact_case,
    )

    exact_tol = (EXACT_TOL_MAX, EXACT_TOL_MEAN)

    # The bench brick, and the multi-brick views of EXACT_BRICK_VIEWS (off
    # axis with a saturating TF; the eye inside the volume and inside a
    # brick; rays along brick faces; a jittered sample), clip planes and a
    # carry in.
    for case, dtype in [("single", torch.float32)] + [(v, torch.uint8) for v in EXACT_BRICK_VIEWS]:
        for filter_mode in ("nearest", "trilinear"):
            c = exact_case(case, seed=0, device=dev, filter_mode=filter_mode, dtype=dtype)
            what = (f"seeded K3 {case} {tuple(c.atlas.shape)} {c.atlas.dtype} "
                    f"{filter_mode}, {c.carry.shape[0]} rays")
            args = (c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params)
            n_rays, n_bricks = c.carry.shape[0], c.slots.shape[0]
            counts = [(torch.zeros(n_rays, dtype=torch.int32, device=dev),
                       torch.zeros(n_bricks, dtype=torch.int32, device=dev)) for _ in range(2)]
            # The plain march's bricks sampled per tile, against K3's lists.
            lists = raycast.tile_bricks_reference(c.rays, c.boxes, c.eye, c.width)
            tile_used = torch.zeros_like(lists)
            got = exact.march_exact(*args, max_steps=c.max_steps, width=c.width,
                                    samples=counts[0][0], used=counts[0][1])
            want = exact.march_exact_reference(*args, max_steps=c.max_steps,
                                               samples=counts[1][0], used=counts[1][1],
                                               width=c.width, tile_used=tile_used)
            torch.cuda.synchronize()
            compare(got, want, what, exact_tol)
            check_k3_counts((got, *counts[0]), (want, *counts[1]), what, c.params.early_exit)
            if not bool((tile_used <= lists).all()):
                raise AssertionError(f"{what}: a tile samples a brick off its list")
            print(f"  tiles list {int(lists.sum())} of {lists.numel()} (tile, brick) pairs and "
                  f"sample {int(tile_used.sum())}")
            saturated = float((got[:, 3] > c.params.early_exit).float().mean())
            print(f"  early exit reached by {saturated:.3f} of the rays")
            if saturated == 0.0:
                raise AssertionError(f"{what}: the early exit never fired")
            del c, args, got, want, lists, tile_used

    phase_done(8)
    # --------------------------------------- 9. the exact main path
    exact.march_exact.launches = 0
    cli_ok = {}
    with tempfile.TemporaryDirectory() as out_dir, Recorder("exact_march") as k3_cli:
        for renderer in ("pallas-exact", "xla"):
            t0 = time.perf_counter()
            rc = render_cli.main([
                "--volume", URI, "--width", "512", "--height", "512",
                "--renderer", renderer, "--output-dir", os.path.join(out_dir, renderer),
            ])
            torch.cuda.synchronize()
            cli_ok[renderer] = (rc, time.perf_counter() - t0, read_image(
                os.path.join(out_dir, renderer, "frame_000000.png")))
    exact_cli_launches = exact.march_exact.launches
    exact_frames, exact_ms, exact_stats = [], [], []
    for camera, frustum in poses:
        t0 = time.perf_counter()
        img, st, _ = engine.render(camera, frustum, screen_space_error=1.0, marcher="pallas")
        torch.cuda.synchronize()
        exact_ms.append((time.perf_counter() - t0) * 1e3)
        exact_frames.append(img)
        exact_stats.append(st)
    exact_launches = exact.march_exact.launches
    # ------------------------------------------ end of the exact main path

    for renderer, (rc, secs, png) in cli_ok.items():
        if rc != 0 or png.shape[:2] != (512, 512) or png.max() == 0:
            raise AssertionError(f"render_cli --renderer {renderer}: rc {rc}, {png.shape}")
        print(f"render_cli --renderer {renderer} 512x512 frame incl. data generation: "
              f"{secs:.3f} s {card}")
    if not np.array_equal(cli_ok["pallas-exact"][2], cli_ok["xla"][2]):
        raise AssertionError("render_cli: pallas-exact and xla frames differ")
    if exact_cli_launches != 2:
        raise AssertionError(f"K3 launched {exact_cli_launches} times for 2 CLI frames")
    want_launches = sum(st.n_passes for st in exact_stats)  # one sample per pixel
    if exact_launches - exact_cli_launches != want_launches or want_launches != len(poses):
        raise AssertionError(
            f"K3 launched {exact_launches - exact_cli_launches} times for "
            f"{len(poses)} orbit frames of {want_launches} passes"
        )
    for i, img in enumerate(exact_frames):
        if tuple(img.shape) != (512, 512, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"exact orbit frame {i}: {tuple(img.shape)} or non-finite")
        if float(img[..., 3].max()) <= 0.0:
            raise AssertionError(f"exact orbit frame {i} is empty")
    st = exact_stats[-1]
    print(
        f"exact main path: {st.n_available} bricks in {st.n_passes} pass(es) per frame, "
        f"{exact_launches} K3 launches for 2 CLI + {len(poses)} orbit frames"
    )
    steady = sorted(exact_ms[1:])
    print(
        f"exact orbit first frame: {exact_ms[0]:.1f} ms; steady frames 2-{len(poses)}: "
        f"median {steady[len(steady) // 2]:.3f} ms, min {steady[0]:.3f} ms {card}"
    )

    # The last pose's operands, as engine.render builds them.
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops.raycast import ray_pack

    camera, frustum = poses[-1]
    t0 = time.perf_counter()
    nodes = engine.select(frustum, 512, 1.0)
    select_ms = (time.perf_counter() - t0) * 1e3
    exact_params = RenderParams(
        n_samples_per_ray=512, data_source_range=engine.data_source_range,
        filter_mode=engine.filter_mode,
    )
    eye_np = np.asarray(camera.inv_mv, np.float32)[:3, 3]
    order = engine._sort_nodes(nodes, eye_np)
    entries = [e.pin() for e in engine._upload_nodes(order)]
    slots, boxes = engine._pass_operands(order, [e.value for e in entries])
    max_steps = engine._max_steps(order, exact_params)
    eye_t, dirs, cos_z, _ = ray_ops.make_rays(
        camera.inv_proj, camera.inv_mv, camera.viewport, device=dev
    )
    half = np.asarray(engine.info.world_size, np.float32) * 0.5
    pack = ray_pack(
        eye_t, dirs.reshape(-1, 3), ray_ops.near_plane_t(cos_z.reshape(-1), camera.near),
        exact_params.step_size, -half, half,
    )
    atlas, tf = engine.atlas.data, engine.transfer_function
    n_rays = pack.shape[1]
    carry0 = torch.zeros((n_rays, 4), device=dev)
    args = (atlas, slots, boxes, tf, pack, carry0, eye_np, exact_params)
    k3_samples = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    k3_used = torch.zeros(len(order), dtype=torch.int32, device=dev)
    frame = exact.march_exact(*args, max_steps=max_steps, width=512,
                              samples=k3_samples, used=k3_used)
    torch.cuda.synchronize()
    if float((frame.reshape(512, 512, 4) - exact_frames[-1]).abs().max()) != 0.0:
        raise AssertionError("the rebuilt operands do not give the orbit's last frame")
    k3_ms = cuda_ms(lambda: exact.march_exact(*args, max_steps=max_steps, width=512), reps=20)
    composited = int(k3_samples.sum())
    used_bricks = int(k3_used.sum())
    ended = float((frame[:, 3] > exact_params.early_exit).float().mean())
    k3_bound = k3_bound_of(k3_samples, k3_used, engine.atlas.slot_bytes, len(order), n_rays,
                           exact_params.filter_mode, atlas.dtype == torch.float32)
    lists = raycast.tile_bricks_reference(pack, boxes, eye_np, 512)
    n_tiles = lists[..., 0].numel()
    print(
        f"  K3's brick lists on the orbit view: the {n_tiles} tiles of 16x8 rays list "
        f"{int(lists.sum()) / n_tiles:.1f} of the pass's {len(order)} bricks on average, at "
        f"most {int(lists.sum(dim=-1).max())}"
    )
    del lists
    sites.append(("K3", "RenderEngine.render, orbit frames (sse 1)",
                  exact_launches - exact_cli_launches, k3_ms, k3_bound))
    # The CLI frames' launches (sse 4; the two renderers march the same
    # operands), on the operands they were given.
    cli_times = []
    for _name, cli_args in k3_cli.calls:
        cli_frame, cli_samples, cli_used = k3_counts(cli_args)
        cli_atlas = cli_args[0]
        cli_bound = k3_bound_of(cli_samples, cli_used, cli_atlas[0].numel() * cli_atlas.element_size(),
                                cli_args[11], cli_args[12],
                                "trilinear" if cli_args[10] else "nearest",
                                cli_atlas.dtype == torch.float32)
        cli_times.append(cuda_ms(lambda: _kernels.launch("exact_march", *cli_args), reps=20))
        print(
            f"K3 on a render_cli frame's operands ({cli_args[12]} rays, {cli_args[11]} bricks, "
            f"{int(cli_samples.sum())} samples composited, {int(cli_used.sum())} bricks sampled): "
            f"{cli_times[-1]:.4f} ms; bound {cli_bound[0]:.4f} ms ({cli_bound[1]}) {card}"
        )
    sites.insert(len(sites) - 1, ("K3", "RenderEngine.render, render_cli frames (sse 4)",
                                  exact_cli_launches, float(np.mean(cli_times)), cli_bound))
    del k3_cli, cli_args, cli_atlas, cli_frame
    # The same frame from only the bricks some ray samples: what the
    # other bricks still cost (their culling in each tile's prologue).
    keep = k3_used.bool()
    sampled_args = (atlas, slots[keep].contiguous(), boxes[keep].contiguous(), tf, pack,
                    carry0, eye_np, exact_params)
    if not torch.equal(exact.march_exact(*sampled_args, max_steps=max_steps, width=512), frame):
        raise AssertionError("the bricks that take no sample changed the frame")
    k3_sampled_ms = cuda_ms(
        lambda: exact.march_exact(*sampled_args, max_steps=max_steps, width=512), reps=20
    )
    print(f"exact steady frame breakdown: select_visibles {select_ms:.3f} ms (host) {card}")
    print(
        f"K3 on the orbit view's operands (512x512 rays, {len(order)} bricks, "
        f"{exact_params.filter_mode}, {exact_params.n_samples_per_ray} samples per ray): kernel "
        f"{k3_ms:.4f} ms; {composited} samples composited "
        f"({composited / n_rays:.1f} per ray), {used_bricks} bricks sampled, rays "
        f"ending in the early exit {ended:.4f}; {composited / (k3_ms * 1e-3) / 1e9:.3f} "
        f"G samples/s; bound {k3_bound[0]:.4f} ms ({k3_bound[1]}), kernel at "
        f"{k3_bound[0] / k3_ms:.4f} of it {card}"
    )
    print(
        f"  the same frame from the {used_bricks} sampled bricks alone: kernel "
        f"{k3_sampled_ms:.4f} ms (culling the other {len(order) - used_bricks} bricks per "
        f"tile costs the difference) {card}"
    )

    phase_done(9)
    # ------------------ 10. K3 vs plain on a window of the main path's rays
    lo = (512 - SUBSET) // 2
    sub = pack.reshape(8, 512, 512)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    sub = sub.reshape(8, -1).contiguous()
    sub_args = (atlas, slots, boxes, tf, sub, torch.zeros((SUBSET * SUBSET, 4), device=dev),
                eye_np, exact_params)
    counts = [(torch.zeros(SUBSET * SUBSET, dtype=torch.int32, device=dev),
               torch.zeros(len(order), dtype=torch.int32, device=dev)) for _ in range(2)]
    lists = raycast.tile_bricks_reference(sub, boxes, eye_np, SUBSET)
    tile_used = torch.zeros_like(lists)
    got = exact.march_exact(*sub_args, max_steps=max_steps, width=SUBSET,
                            samples=counts[0][0], used=counts[0][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = exact.march_exact_reference(*sub_args, max_steps=max_steps, samples=counts[1][0],
                                       used=counts[1][1], width=SUBSET, tile_used=tile_used)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    what = f"main-path K3, {SUBSET}x{SUBSET} window"
    k3_err = compare(got, want, what, exact_tol)
    check_k3_counts((got, *counts[0]), (want, *counts[1]), what, exact_params.early_exit)
    if not bool((tile_used <= lists).all()):
        raise AssertionError(f"{what}: a tile samples a brick off its list")
    k3_sub_ms = cuda_ms(lambda: exact.march_exact(*sub_args, max_steps=max_steps, width=SUBSET),
                        reps=20)
    print(
        f"  on the {SUBSET}x{SUBSET} window: kernel {k3_sub_ms:.4f} ms, plain "
        f"{k3_plain_ms:.3f} ms (1 call) {card}"
    )
    for e in entries:
        e.unpin()
    del args, sampled_args, sub_args, pack, frame

    phase_done(10)
    # --------------------------------------------- 11. card vs CPU, exact
    # A 9-slot atlas forces passes of 8 bricks, the carry threaded through
    # them; two jittered samples per pixel.
    camera, frustum = build_camera(48, 40, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    small_params = RenderParams(n_samples_per_ray=128, samples_per_pixel=2,
                                filter_mode="trilinear")
    slot_mb = RenderEngine(DataSource(small), max_gpu_cache_mb=1, device="cpu") \
        .atlas.slot_bytes / 2**20
    frames = [
        RenderEngine(DataSource(small), max_gpu_cache_mb=18 * slot_mb, device=d)
        .render(camera, frustum, params=small_params, screen_space_error=1.0)
        for d in (dev, "cpu")
    ]
    (on_card, st_card, _), (on_cpu, st_cpu, _) = frames
    small_err = float((on_card.cpu() - on_cpu).abs().max())
    print(
        f"small volume, exact path, card vs CPU port ({st_card.n_available} bricks in "
        f"{st_card.n_passes} passes, 2 samples per pixel): max|d| {small_err:.3e}"
    )
    if st_card.n_passes < 2 or st_card.n_passes != st_cpu.n_passes:
        raise AssertionError(f"passes: card {st_card.n_passes}, CPU {st_cpu.n_passes}")
    if small_err > EXACT_TOL_MAX or float(on_cpu[..., 3].max()) <= 0.0:
        raise AssertionError(f"card exact frame disagrees with the CPU port ({small_err})")

    phase_done(11)
    # ---------------------------------------- 12. K4 vs plain, seeded cases
    from libre_tpu_torch.testing import EXACT_GRAD_TOL_MAX, exact_grad_case

    def brick_args(volume, tf_, view):
        """K3's operands for one brick filling the view's box, less the carry."""
        slot = torch.zeros(1, dtype=torch.int32, device=volume.device)
        return (volume[None], slot, view.brick_boxes, tf_, view.ray_pack)

    def k4_work_bound(volume, view, samples, filter_mode, diff_tf):
        return k4_bound_of(volume.numel(), view.n_rays, samples, filter_mode, diff_tf)

    def compare_k4(got, want, what, zero_d_volume=False):
        errs = [compare_grads(a, b, f"{what}: {name}", 1.1, EXACT_GRAD_TOL_MAX,
                              expect_zero=zero_d_volume and name == "d_volume")
                for name, a, b in zip(("d_volume", "d_tf"), got, want)]
        return errs, max(float((a - b).abs().max()) for a, b in zip(got, want))

    # Both scenes on the random field, the bench scene on every other
    # field; the TF gradient on, and off (d_volume as with it on, d_tf 0).
    k4_cases = [("bench", f) for f in FIELDS] + [("wide", "random")]
    for case, field in k4_cases:
        for filter_mode in ("nearest", "trilinear"):
            c = exact_grad_case(case, seed=0, device=dev, filter_mode=filter_mode, field=field)
            args = (c.volume, c.tf, c.view, c.out, c.g)
            got = exact.march_exact_backward(*args)
            no_tf = exact.march_exact_backward(*args, diff_tf=False)
            want = exact.march_exact_backward_reference(*args)
            torch.cuda.synchronize()
            what = f"seeded K4 {case} {field} {tuple(c.volume.shape)} {filter_mode}, " \
                   f"{c.view.n_rays} rays"
            compare_k4(got, want, what, zero_d_volume=field == "top")
            compare_grads(no_tf[0], want[0], f"{what}, diff_tf=False: d_volume", 1.1,
                          EXACT_GRAD_TOL_MAX, expect_zero=field == "top")
            if float(no_tf[1].abs().max()) != 0.0:
                raise AssertionError(f"{what}, diff_tf=False: d_tf is not zero")
            del c, args, got, no_tf, want

    # The autograd round trip at the exact_fwd_bwd shape (trilinear), and
    # its rate: rays / (K3 + K4 + the product, sum and accumulation).
    c = exact_grad_case("bench", seed=1, device=dev)
    vol = c.volume.clone().requires_grad_()
    tf_leaf = c.tf.clone().requires_grad_()
    exact.render_exact_diff(vol, tf_leaf, c.view).mul(c.g).sum().backward()
    args = (c.volume, c.tf, c.view, c.out, c.g)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    compare_k4((vol.grad, tf_leaf.grad), want, "render_exact_diff backward on the card")

    def fwd_bwd():
        vol.grad = tf_leaf.grad = None
        exact.render_exact_diff(vol, tf_leaf, c.view).mul(c.g).sum().backward()

    fb_ms = cuda_ms(fwd_bwd, reps=10)
    with torch.no_grad():
        bench_k3_ms = cuda_ms(lambda: exact.render_exact_diff(c.volume, c.tf, c.view), reps=10)
    bench_k4_ms = cuda_ms(lambda: exact.march_exact_backward(*args), reps=10)
    bench_k4_no_tf_ms = cuda_ms(lambda: exact.march_exact_backward(*args, diff_tf=False),
                                reps=10)
    bench_samples = torch.zeros(c.view.n_rays, dtype=torch.int32, device=dev)
    exact.march_exact(*brick_args(c.volume, c.tf, c.view), torch.zeros_like(c.out),
                      c.view.eye, c.view.params,
                      max_steps=c.view.max_steps, width=c.view.width, samples=bench_samples)
    n_bench = int(bench_samples.sum())
    bench_bound = k4_work_bound(c.volume, c.view, n_bench, "trilinear", True)
    print(
        f"exact fwd+bwd at the exact_fwd_bwd shape (64^3 f32, 256x256 rays, 512 samples "
        f"per ray, trilinear, {n_bench} samples): {fb_ms:.4f} ms per step, "
        f"{c.view.n_rays / (fb_ms * 1e-3) / 1e6:.3f} Mrays/s; K3 {bench_k3_ms:.4f} ms, "
        f"K4 {bench_k4_ms:.4f} ms ({bench_bound[1]}-bound) {card}"
    )
    rate("K4 at the exact_fwd_bwd shape, diff_tf=True", bench_k4_ms, n_bench,
         bench_bound[0], card)
    rate("K4 at the exact_fwd_bwd shape, diff_tf=False", bench_k4_no_tf_ms, n_bench,
         k4_work_bound(c.volume, c.view, n_bench, "trilinear", False)[0], card
    )
    del c, vol, tf_leaf, args, want

    phase_done(12)
    # ---------------------------------- 13. the exact training path, full width
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.testing import smooth_volume
    from libre_tpu_torch.train import init_exact_state, make_exact_train_step

    n = EXACT_TRAIN_N
    gt = smooth_volume(n, seed=7, device=dev)
    tf_default = torch.from_numpy(default_color_map()).to(dev)
    train_params = RenderParams(
        n_samples_per_ray=512, data_source_range=(0.0, 1.0), filter_mode="trilinear",
        early_exit=1.1,
    )
    ex_views = [exact.exact_view(build_camera(512, 512, e, (0.0, 0.0, 0.0))[0], train_params,
                                 device=dev)
                for e in EXACT_EYES]
    with torch.no_grad():
        ex_targets = [exact.render_exact_diff(gt, tf_default, v) for v in ex_views]
    state = init_exact_state(torch.full((n, n, n), 0.5, device=dev), tf_default,
                             lambda p: torch.optim.Adam(p, lr=5e-2), device=dev)
    ex_steps = [make_exact_train_step(v) for v in ex_views]
    ex_losses, ex_step_at = [], []
    torch.cuda.synchronize()
    exact.march_exact.launches = 0
    exact.march_exact_backward.launches = 0
    t0 = time.perf_counter()
    with adam_counted(f"exact trainer ({n}^3 density)", 2 * len(EXACT_TRAIN_ORDER)):
        for i in EXACT_TRAIN_ORDER:
            ex_losses.append(float(ex_steps[i](state, ex_targets[i])))  # synchronises
            ex_step_at.append(time.perf_counter())
    ex_fwd_launches = exact.march_exact.launches
    ex_bwd_launches = exact.march_exact_backward.launches
    # ----------------------------------- end of the exact training path

    print(f"exact training losses (views {list(EXACT_TRAIN_ORDER)}): {ex_losses}")
    if not all(np.isfinite(ex_losses)) or not ex_losses[-1] < ex_losses[0]:
        raise AssertionError(f"exact training did not lower view 0's loss: {ex_losses}")
    n_steps = len(EXACT_TRAIN_ORDER)
    if ex_fwd_launches != n_steps or ex_bwd_launches != n_steps:
        raise AssertionError(
            f"exact training launched K3 {ex_fwd_launches} and K4 {ex_bwd_launches} "
            f"times in {n_steps} steps"
        )
    p_vol, p_tf = state.params["density"].detach(), state.params["tf"].detach()
    if float(p_tf.min()) < 0.0 or float(p_tf.max()) > 1.0:
        raise AssertionError("exact training left the TF outside [0, 1]")
    ex_steps_ms = np.diff([t0] + ex_step_at) * 1e3
    ex_step_ms = float(np.median(ex_steps_ms[1:]))
    v0 = ex_views[0]
    print(
        f"exact training: {n}^3 f32 volume, {len(ex_views)} views of 512x512 rays, 512 "
        f"samples per ray, trilinear, early exit off; K3 launches {ex_fwd_launches}, K4 "
        f"launches {ex_bwd_launches}; mean |density - truth| "
        f"{float((p_vol - gt).abs().mean()):.4f}"
    )
    print(
        f"exact training step: median of steps 2-{n_steps} {ex_step_ms:.3f} ms (all steps "
        f"{', '.join(f'{x:.3f}' for x in ex_steps_ms)} ms); fwd+bwd "
        f"{v0.n_rays / (ex_step_ms * 1e-3) / 1e6:.3f} Mrays/s {card}"
    )

    # Where a step's device time goes: one more step of view 0, after the
    # counts were read (K4, K3, the optimizer's foreach kernels, fills,
    # reductions).
    profiled(
        "one exact training step", lambda: float(ex_steps[0](state, ex_targets[0])),
        ("exact_march_bwd", "exact_march_kernel", "multi_tensor_apply", "Fill", "reduce"),
        card, ex_step_ms,
    )

    # View 0 with the trained state, kernel vs plain: the forward's out and
    # a seeded N(0, 1) cotangent in place of the loss's.
    fwd_args = (*brick_args(p_vol, p_tf, v0), torch.zeros((v0.n_rays, 4), device=dev))
    samples0 = torch.zeros(v0.n_rays, dtype=torch.int32, device=dev)
    out0 = exact.march_exact(*fwd_args, v0.eye, v0.params, max_steps=v0.max_steps,
                             width=v0.width, samples=samples0)
    gen = torch.Generator(device="cpu").manual_seed(0)
    g0 = torch.randn(out0.shape, generator=gen).to(dev)
    args = (p_vol, p_tf, v0, out0, g0)
    got = exact.march_exact_backward(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    k4_plain_ms = (time.perf_counter() - t1) * 1e3
    _, k4_err = compare_k4(got, want, "K4 on training view 0")
    del got, want
    k3_view_ms = cuda_ms(lambda: exact.march_exact(*fwd_args, v0.eye, v0.params,
                                                   max_steps=v0.max_steps, width=v0.width),
                         reps=10)
    n_view = int(samples0.sum())
    # K3's bound on the training view: the one f32 brick read once.
    used0 = torch.ones(1, dtype=torch.int32)
    k3_train_bound = k3_bound_of(samples0, used0, p_vol.numel() * 4, 1, v0.n_rays,
                                 train_params.filter_mode, True)
    rate("K3 on exact training view 0", k3_view_ms, n_view, k3_train_bound[0], card)
    sites.append(("K3", "render_exact_diff forward (exact training)", ex_fwd_launches,
                  k3_view_ms, k3_train_bound))
    # The same view over the 512^3 smooth ground truth with the default TF
    # (the bins move every few samples along each ray), kernel vs plain;
    # its forward is the training target of view 0.  Three seeded
    # cotangents, K4 twice on each (its float atomics add in an order that
    # changes from run to run), K4's and the plain version's d_tf also
    # against the plain version over float64 operands.
    gt_args = (gt, tf_default, v0, ex_targets[0], g0)
    gt64 = (gt.double(), tf_default.double(), v0, ex_targets[0].double())
    dtf_errs = {"plain": [], "float64": [], "run to run": [], "plain vs float64": []}
    for seed in (0, 1, 2):
        g_s = torch.randn(out0.shape, generator=torch.Generator().manual_seed(seed)).to(dev)
        runs = [exact.march_exact_backward(*gt_args[:4], g_s) for _ in range(2)]
        want = exact.march_exact_backward_reference(*gt_args[:4], g_s)
        want64 = exact.march_exact_backward_reference(*gt64, g_s.double())[1]
        torch.cuda.synchronize()
        what = f"K4 on view 0 over the ground truth, cotangent seed {seed}"
        for i, got in enumerate(runs):
            (_, e_tf), mx = compare_k4(got, want, f"{what}, run {i + 1}")
            k4_err = max(k4_err, mx)
            dtf_errs["plain"].append(e_tf)
            dtf_errs["float64"].append(compare_grads(
                got[1], want64, f"{what}, run {i + 1}: d_tf vs float64", 1.1, EXACT_GRAD_TOL_MAX))
        dtf_errs["run to run"].append(
            float((runs[0][1] - runs[1][1]).abs().max()) / float(want64.abs().max()))
        dtf_errs["plain vs float64"].append(compare_grads(
            want[1], want64, f"{what}: the plain d_tf vs float64", 1.1, EXACT_GRAD_TOL_MAX))
        del runs, want, want64
    print("K4's d_tf over the ground truth, 3 cotangent seeds x 2 runs, largest error of its "
          "largest entry: " + "; ".join(f"{k} {max(v):.3e}" for k, v in dtf_errs.items()))
    del gt64
    k4_bound = k4_work_bound(p_vol, v0, n_view, train_params.filter_mode, True)
    k4_bound_no_tf = k4_work_bound(p_vol, v0, n_view, train_params.filter_mode, False)
    k4_times = {}  # (state, diff_tf) -> ms, incl. zeroing the 512 MiB d_volume
    for state, operands in (("trained", args), ("ground truth", gt_args)):
        for diff_tf in (True, False):
            k4_times[state, diff_tf] = cuda_ms(
                lambda: exact.march_exact_backward(*operands, diff_tf=diff_tf), reps=5, warmup=1
            )
            rate(f"K4 on view 0, {state}, diff_tf={diff_tf}", k4_times[state, diff_tf], n_view,
                 (k4_bound if diff_tf else k4_bound_no_tf)[0], card)
    k4_ms = k4_times["trained", True]
    print(
        f"training view 0: {n_view} samples ({n_view / v0.n_rays:.1f} per ray, at most "
        f"{int(samples0.max())}); K3 {k3_view_ms:.4f} ms, K4 {k4_ms:.4f} ms (incl. zeroing "
        f"the {p_vol.numel() * 4} B d_volume; {k4_times['trained', False]:.4f} ms without the "
        f"TF gradient; ground truth {k4_times['ground truth', True]:.4f} / "
        f"{k4_times['ground truth', False]:.4f} ms), plain backward {k4_plain_ms:.3f} ms "
        f"(1 call) {card}"
    )
    print(
        f"  K4 bound on view 0: {k4_bound[0]:.4f} ms, {k4_bound[1]}-bound; without the TF "
        f"gradient {k4_bound_no_tf[0]:.4f} ms {card}"
    )
    del gt, ex_targets, gt_args

    # K3 and K4 vs plain on a 64x64 window of view 0's rays (the 512^3
    # brick, long rays, the early exit off).
    lo = (512 - SUBSET) // 2
    sub = v0.ray_pack.reshape(8, 512, 512)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    w0 = dataclasses.replace(v0, ray_pack=sub.reshape(8, -1).contiguous(), width=SUBSET)
    sub_fwd = (*brick_args(p_vol, p_tf, w0), torch.zeros((w0.n_rays, 4), device=dev))
    counts = [(torch.zeros(w0.n_rays, dtype=torch.int32, device=dev),
               torch.zeros(1, dtype=torch.int32, device=dev)) for _ in range(2)]
    out_w = exact.march_exact(*sub_fwd, w0.eye, w0.params, max_steps=w0.max_steps,
                              width=w0.width, samples=counts[0][0], used=counts[0][1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_w = exact.march_exact_reference(*sub_fwd, w0.eye, w0.params, max_steps=w0.max_steps,
                                         samples=counts[1][0], used=counts[1][1])
    torch.cuda.synchronize()
    k3_plain_window_ms = (time.perf_counter() - t1) * 1e3
    what = f"K3 on a {SUBSET}x{SUBSET} window of training view 0"
    k3_train_err = compare(out_w, want_w, what, exact_tol)
    check_k3_counts((out_w, *counts[0]), (want_w, *counts[1]), what, train_params.early_exit)
    g_w = g0.reshape(512, 512, 4)[lo:lo + SUBSET, lo:lo + SUBSET].reshape(-1, 4).contiguous()
    sub_args = (p_vol, p_tf, w0, out_w, g_w)
    got = exact.march_exact_backward(*sub_args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = exact.march_exact_backward_reference(*sub_args)
    torch.cuda.synchronize()
    k4_plain_window_ms = (time.perf_counter() - t1) * 1e3
    compare_k4(got, want, f"K4 on a {SUBSET}x{SUBSET} window of training view 0")
    k4_window_ms = cuda_ms(lambda: exact.march_exact_backward(*sub_args), reps=10)
    print(
        f"  on the {SUBSET}x{SUBSET} window: K4 {k4_window_ms:.4f} ms, plain "
        f"{k4_plain_window_ms:.3f} ms (1 call); K3 plain {k3_plain_window_ms:.3f} ms "
        f"(1 call) {card}"
    )
    del state, p_vol, args, sub_args, got, want, want_w, fwd_args, sub_fwd

    phase_done(13)
    # ------------------------------------ 14. the exact trainer, card vs CPU
    # The same start and target on both devices: the target is the CPU's.
    rng = np.random.default_rng(3)
    small_density = (0.5 + 0.05 * rng.standard_normal((32, 32, 32))).astype(np.float32)
    small_tf = np.clip(default_color_map() * 0.7 + 0.05, 0.0, 1.0).astype(np.float32)
    small_params = RenderParams(n_samples_per_ray=64, data_source_range=(0.0, 1.0),
                                filter_mode="trilinear", early_exit=1.1)
    camera, _ = build_camera(24, 20, EXACT_EYES[0], (0.0, 0.0, 0.0))
    with torch.no_grad():
        small_target = exact.render_exact_diff(
            smooth_volume(32, seed=7, device="cpu"), torch.from_numpy(default_color_map()),
            exact.exact_view(camera, small_params, device="cpu"),
        )
    trained, small_losses = [], []
    for d in (dev, "cpu"):
        st = init_exact_state(small_density, small_tf,
                              lambda p: torch.optim.SGD(p, lr=5.0), device=d)
        step = make_exact_train_step(exact.exact_view(camera, small_params, device=d))
        small_losses.append([float(step(st, small_target.to(d))) for _ in range(2)])
        trained.append({k: v.detach().cpu() for k, v in st.params.items()})
    small_err = max(float((trained[0][k] - trained[1][k]).abs().max()) for k in trained[1])
    moved = float((trained[1]["density"] - torch.from_numpy(small_density)).abs().max())
    print(
        f"small exact trainer, card vs CPU port (32^3, 24x20 rays, 2 SGD steps, losses "
        f"{small_losses[0]} / {small_losses[1]}): params max|d| {small_err:.3e}, "
        f"density moved {moved:.3e}"
    )
    if small_err > 1e-4 or moved < 1e-3:
        raise AssertionError(f"card exact trainer disagrees with the CPU port ({small_err})")

    phase_done(14)
    # ----------------------------------------- 15. K5 vs plain, seeded cases
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.testing import (
        DENSE_EYES,
        DENSE_GRAD_TOL,
        DENSE_SWEEP_SHAPES,
        dense_case,
        dense_grad_case,
        dense_plain,
    )

    # The JAX dense scene from four eyes, the 512^3 stack (K = Na) and a
    # stack with empty slices under every sweep view, ragged tiles with
    # K != Na and K = Na: K5 bit-equal to plain, its plain plane lists a
    # superset of the planes each tile composites at.
    dense_cases = (
        [("scene", dict(eye=e)) for e in DENSE_EYES] + [("slice", {})]
        + [("sweep", dict(view=v, shape=s)) for v in SWEEP_VIEWS
           for s in DENSE_SWEEP_SHAPES]
    )
    for case, args in dense_cases:
        c = dense_case(case, seed=0, device=dev, **args)
        kw = c.kw
        got = swd.pre_sweep(c.chans, c.tables, **kw)
        want, fetches, lists = dense_plain(c)
        torch.cuda.synchronize()
        k_planes = c.tables.a0.shape[0]
        v_size, u_size = c.tables.corr.shape
        what = (f"seeded K5 {case} {' '.join(str(a) for a in args.values())} "
                f"{tuple(c.chans.shape)}, {v_size}x{u_size} rays x {k_planes} planes")
        compare(got, want, what)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: K5 is not bit-equal to the plain sweep")
        if not bool((fetches <= lists).all()):
            raise AssertionError(f"{what}: a tile composites at a plane off its list")
        n_act = int(c.tables.act.sum())
        saturated = float((got[..., 3] > kw["early_exit"]).float().mean())
        print(f"  bit-equal; active planes {n_act}/{k_planes}, early exit reached by "
              f"{saturated:.3f} of the rays; tiles list {int(lists.sum())} of {lists.numel()} "
              f"(tile, plane) pairs and composite at {int(fetches.sum())}")
        if n_act == k_planes or (case != "sweep" and saturated == 0.0):
            raise AssertionError(f"{what}: no early exit or no empty plane")
        del c, got, want, lists, fetches

    phase_done(15)
    # ------------------------------------------------- 16. the dense main path
    # The plain sweep and the plain pipeline must not run on the card's
    # main path: count their calls.  The first frame's level assembly and
    # classification are timed apart.
    plain_calls = []
    spans = {}
    real_fns = (swd.pre_sweep_reference, sw.render_slope_grid, swd.classify_planes)

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spans[name] = spans.get(name, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return wrapper

    swd.pre_sweep_reference = counted(real_fns[0])
    sw.render_slope_grid = counted(real_fns[1])
    swd.classify_planes = timed("classify", real_fns[2])
    dense_engine = RenderEngine(DataSource(URI), device=dev)
    dense_engine._level_volume = timed("level", dense_engine._level_volume)
    try:
        swd.pre_sweep.launches = 0
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            rc = render_cli.main([
                "--volume", URI, "--width", "512", "--height", "512",
                "--renderer", "shearwarp", "--output-dir", out_dir,
            ])
            torch.cuda.synchronize()
            dense_cli_s = time.perf_counter() - t0
            dense_png = read_image(os.path.join(out_dir, "frame_000000.png"))
        dense_cli_launches = swd.pre_sweep.launches
        cli_spans = dict(spans)
        spans.clear()
        dense_frames, dense_ms = [], []
        for camera, _frustum in poses:
            t0 = time.perf_counter()
            dense_frames.append(dense_engine.render_shearwarp(camera))
            torch.cuda.synchronize()
            dense_ms.append((time.perf_counter() - t0) * 1e3)
        dense_launches = swd.pre_sweep.launches
    finally:
        swd.pre_sweep_reference, sw.render_slope_grid, swd.classify_planes = real_fns
    # ------------------------------------------- end of the dense main path

    if rc != 0 or dense_png.shape[:2] != (512, 512) or dense_png.max() == 0:
        raise AssertionError(f"render_cli --renderer shearwarp: rc {rc}, {dense_png.shape}")
    if plain_calls:
        raise AssertionError(f"the dense main path ran plain versions: {plain_calls}")
    if dense_cli_launches != 1 or dense_launches != 1 + len(poses):
        raise AssertionError(
            f"pre_sweep launched {dense_cli_launches} times for the CLI frame and "
            f"{dense_launches - dense_cli_launches} for {len(poses)} orbit frames"
        )
    for i, img in enumerate(dense_frames):
        if tuple(img.shape) != (512, 512, 4) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"dense orbit frame {i}: {tuple(img.shape)} or non-finite")
        if float(img[..., 3].max()) <= 0.0:
            raise AssertionError(f"dense orbit frame {i} is empty")
    if len(dense_engine._classified_cache) != 1:
        raise AssertionError(
            f"the orbit classified {len(dense_engine._classified_cache)} stacks, expected 1"
        )
    (chans, content, _tf, _version), = [dense_engine._classified_cache.get(k)
                                        for k in list(dense_engine._classified_cache)]
    level = dense_engine.info.root_node.depth - 1
    print(
        f"dense main path: level {level}, classified stack {tuple(chans.shape)} = "
        f"{chans.numel() * 4} B (device budget {dense_engine.device_budget.budget} B), "
        f"{dense_launches} K5 launches for 1 CLI + {len(poses)} orbit frames, no plain call"
    )
    print(
        f"render_cli --renderer shearwarp 512x512 frame incl. data generation: "
        f"{dense_cli_s:.3f} s, of which classify {cli_spans['classify']:.1f} ms {card}"
    )
    steady = sorted(dense_ms[1:])
    print(
        f"dense orbit first frame: {dense_ms[0]:.1f} ms = level assembly "
        f"{spans['level']:.1f} ms + classify {spans['classify']:.1f} ms + the rest "
        f"(upload, content flags, tables, sweep, warp) "
        f"{dense_ms[0] - spans['level'] - spans['classify']:.1f} ms; steady frames "
        f"2-{len(poses)}: median {steady[len(steady) // 2]:.3f} ms, min {steady[0]:.3f} ms {card}"
    )

    # K5 on the last pose's operands, as render_shearwarp builds them.
    camera, _frustum = poses[-1]
    _vx, _vy, vw, vh = camera.viewport
    half = np.asarray(dense_engine.info.world_size, np.float32) * 0.5
    dense_k = max(max(dense_engine.info.voxels), 256)  # render_shearwarp's default
    dense_params = RenderParams(
        n_samples_per_ray=dense_k, data_source_range=dense_engine.data_source_range,
        filter_mode="trilinear",
    )
    dense_swp = sw.ShearWarpParams(n_planes=dense_k, inter_size=(vh, vw))
    t0 = time.perf_counter()
    pa = swd.slope_grid_plan_args(sw.make_view_plan(camera, dense_swp.slope_margin),
                                  -half, half, dense_params, dense_swp)
    plan_ms = (time.perf_counter() - t0) * 1e3
    frame = swd.render_frame(chans, chans.shape[1], chans.shape[2], camera, pa, content)
    dense_last = dict(chans=chans, content=content, pa=pa, camera=camera)  # phase 31's bf16 K5
    torch.cuda.synchronize()
    if not torch.equal(frame, dense_frames[-1]):
        raise AssertionError("the rebuilt operands do not give the dense orbit's last frame")
    frame_ms = cuda_ms(
        lambda: swd.render_frame(chans, chans.shape[1], chans.shape[2], camera, pa, content),
        reps=20,
    )
    _fv, tables = swd.sweep_operands(chans, pa, camera, content)
    kw = pa.sweep_kwargs()
    got = swd.pre_sweep(chans, tables, **kw)
    k5_samples = torch.zeros((vh, vw), dtype=torch.int64, device=dev)
    k5_planes = torch.zeros(dense_k, dtype=torch.bool, device=dev)
    k5_touched = torch.zeros(chans.shape[:3], dtype=torch.bool, device=dev)
    k5_lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
    k5_fetches = torch.zeros_like(k5_lists)
    want = swd.pre_sweep_reference(chans, tables, samples=k5_samples, planes=k5_planes,
                                   touched=k5_touched, fetches=k5_fetches, **kw)
    torch.cuda.synchronize()
    k5_err = compare(got, want, "main-path K5")
    if not torch.equal(got, want):
        raise AssertionError("main-path K5 is not bit-equal to the plain sweep")
    if not bool((k5_fetches <= k5_lists).all()):
        raise AssertionError("main-path K5: a tile composites at a plane off its list")
    k5_ms = cuda_ms(lambda: swd.pre_sweep(chans, tables, **kw), reps=20)
    k5_plain_ms = cuda_ms(lambda: swd.pre_sweep_reference(chans, tables, **kw),
                          reps=3, warmup=1)
    vol_dev = torch.from_numpy(dense_engine._level_volume(level)).to(dev)
    tf = dense_engine.transfer_function
    classify_ms = cuda_ms(
        lambda: swd.classify_planes(vol_dev, tf, pa.axis, dense_params.data_source_range),
        reps=3, warmup=1,
    )
    del vol_dev
    n_rays = vh * vw
    composited = int(k5_samples.sum())
    ended = float((want[..., 3] > kw["early_exit"]).float().mean())
    # K5's bound: the RGBA texels under the taps of the composited
    # samples, each read once, the per-ray corr and the output, the plane
    # tables; the composited samples' operations.
    slices = torch.unique(torch.cat([tables.a0[k5_planes], tables.a1[k5_planes]]))
    _na, d_nc, d_nb, _ = chans.shape
    k5_texels = int(k5_touched.sum())
    del k5_touched
    k5_bound = bound(
        bytes_=k5_texels * 16 + n_rays * (4 + 16) + dense_k * 5 * 4,
        ops=composited * K5_OPS_PER_SAMPLE,
    )
    print(
        f"dense steady frame breakdown: view plan {plan_ms:.3f} ms (host), one-upload "
        f"frame (tables, K5, warp) {frame_ms:.4f} ms by CUDA events; classify the "
        f"{tuple(chans.shape[:3])} level {classify_ms:.3f} ms {card}"
    )
    print(
        f"K5 on the orbit view's operands ({vh}x{vw} rays x {dense_k} planes over "
        f"{tuple(chans.shape)}): kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.3f} ms {card}"
    )
    print(
        f"  this view's work: active planes {int(tables.act.sum())}/{dense_k}, planes sampled "
        f"{int(k5_planes.sum())}, rays that composite "
        f"{float((k5_samples > 0).float().mean()):.4f}, rays ending in the early exit "
        f"{ended:.4f}, samples composited {composited} "
        f"({composited / (n_rays * dense_k):.4f} of the grid); kernel "
        f"{composited / (k5_ms * 1e-3) / 1e9:.3f} G samples/s {card}"
    )
    n_tiles = k5_lists[..., 0].numel()
    print(
        f"  bit-equal; the {n_tiles} tiles of {swb.SWEEP_TILE[0]}x{swb.SWEEP_TILE[1]} rays "
        f"list {int(k5_lists.sum()) / n_tiles:.1f} planes each on average (of "
        f"{int(tables.act.sum())} active), at most {int(k5_lists.sum(dim=-1).max())}; they "
        f"composite at {int(k5_fetches.sum()) / n_tiles:.1f}"
    )
    del k5_lists, k5_fetches
    print(
        f"  K5 bound: {k5_texels} RGBA texels read ({k5_texels / (slices.numel() * d_nc * d_nb):.4f} "
        f"of the {slices.numel()} slices of the planes sampled); {k5_bound[0]:.4f} ms, "
        f"{k5_bound[1]}-bound; kernel at {k5_bound[0] / k5_ms:.4f} of it {card}"
    )

    # Where a steady frame's time goes: one more frame of the last pose,
    # after the counts were read.
    def steady_frame():
        dense_engine.render_shearwarp(camera)
        torch.cuda.synchronize()

    profiled("one dense steady frame", steady_frame,
             ("pre_sweep_kernel", "elementwise", "index", "reduce", "cat", "copy"), card,
             steady[len(steady) // 2])
    del got, want, tables, dense_frames, frame

    phase_done(16)
    # ----------------------------------------- 17. dense, card vs CPU
    camera, _frustum = build_camera(48, 48, (0.3, 0.2, 1.5), (0.0, 0.0, 0.0))
    k5_before = swd.pre_sweep.launches
    on_card, on_cpu = [
        RenderEngine(DataSource(small), max_gpu_cache_mb=64, device=d)
        .render_shearwarp(camera, n_planes=64).cpu()
        for d in (dev, "cpu")
    ]
    if swd.pre_sweep.launches != k5_before + 1:
        raise AssertionError("the card's render_shearwarp did not launch K5 once")
    small_err = float((on_card - on_cpu).abs().max())
    print(f"small volume, dense path, card (K5) vs CPU port (plain pipeline): "
          f"max|d| {small_err:.3e}")
    if small_err > SMALL_TOL_MAX or float(on_cpu[..., 3].max()) <= 0.0:
        raise AssertionError(f"card dense frame disagrees with the CPU port ({small_err})")
    # The autograd Function: forward classify + sweep, backward the plain
    # pipeline's recompute, on the card and on the CPU.
    results = []
    for d in (dev, "cpu"):
        vol_g, tf_g, g, pa_g = dense_grad_case(d)
        out_g = swd.render_slope_grid_fused(vol_g, tf_g, pa_g)
        (out_g * g).sum().backward()
        results.append((out_g.detach().cpu(), vol_g.grad.cpu(), tf_g.grad.cpu()))
    fwd_err = float((results[0][0] - results[1][0]).abs().max())
    grad_errs = [float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(results[0][1:], results[1][1:])]
    print(f"render_slope_grid_fused, card vs CPU (20x24x28, 24x40 rays, 24 planes): forward "
          f"max|d| {fwd_err:.3e}; gradients max|d|/max|CPU| volume {grad_errs[0]:.3e}, "
          f"TF {grad_errs[1]:.3e}")
    if fwd_err > SMALL_TOL_MAX or max(grad_errs) > DENSE_GRAD_TOL:
        raise AssertionError(f"card autograd disagrees with the CPU ({fwd_err}, {grad_errs})")

    phase_done(17)
    # ---------------- 18. out of core and asynchronous, at 1024^3 (its own timers)
    ooc_sites, ooc_launches, ooc_err = phase_out_of_core(dev, card)
    phase_done(18, quiet=True)
    # ----------------------- 19. the gather probes P1-P17 (their own timers)
    probe_entries = phase_probes(dev, card)
    phase_done(19, quiet=True)
    # ------------------------------------- 20. the render service (its own timers)
    serve_k1, serve_k3, serve_2x2_ms = phase_serve(dev, card)
    phase_done(20, quiet=True)
    # ------------------------------------- 21. the dense trainer at full width
    phase_dense_trainer(dev, card)
    phase_done(21)
    # ------------------------------------------- 22. VolumeScene at full width
    scene = phase_scene(dev, card, exact_tol)
    phase_done(22)
    # -------------------------------------------- 23. the benchmark scripts
    scripts, script_errs = phase_scripts(card)
    phase_done(23)
    # --------------------------------------------------------- 24. entry()
    entry_k3, entry_err = phase_entry(dev, card, exact_tol)
    phase_done(24)
    # ------------------- 25-29. M9: logical shards of the card (one H100)
    mesh_k1, mesh_sites = phase_sharded_orbit(dev, card, engine, poses)
    phase_done(25)
    train_k1, train_k2, train_sites, mesh_k2_err = phase_sharded_training(
        dev, card, problem, store, tf, targets)
    phase_done(26)
    mesh_k3, k3_sites = phase_sharded_exact(dev, card, exact_tol)
    phase_done(27)
    apps_k1 = phase_mesh_apps(dev, card)
    phase_done(28)
    phase_two_process(dev, card)
    phase_done(29)
    # ------------------- 30. the exact gradient over a brick set (rest of M9)
    exact_set = phase_exact_set(dev, card, exact_tol)
    phase_done(30, quiet=True)
    # ----- 31. K3 and K4 at any TF size, the multi-view wall, the bf16 resample
    p31_launches, p31_errs, p31_instances = phase_finish(
        dev, card, exact_tol, ex_views[0], engine, poses[-1], dense_last, serve_2x2_ms)
    phase_done(31, quiet=True)
    # ------------------------------- 32. the trainers' update (the Adam kernel)
    adam_entry, adam_ms = phase_adam(dev, card)
    print("the Adam kernel's launches on the main paths, each counted from 0 with no fallback "
          "(a leaf a step): " + "; ".join(f"{what} {k}" for what, k in ADAM_RUNS))
    phase_done(32)
    print("phase seconds (utils.profiling.StageTimers):")
    for line in timers.report().splitlines():
        print(f"  {line}")

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "libre_tpu")]
    if loaded:
        raise AssertionError(f"imported {loaded[:5]}")

    # The rule-2 ranking of the port's kernels: per launch site on the
    # main paths, launches x (ms per launch - bound), from this run.
    sites += [
        ("K2", "RenderStoreGridDiff backward (store training)", train_bwd_launches, bwd_ms,
         k2_bound),
        ("K4", "render_exact_diff backward (exact training)", ex_bwd_launches, k4_ms, k4_bound),
        ("K4", "RenderMarcherDiff backward (VolumeScene, exit on)", scene["k4_launches"],
         scene["k4_on_ms"], scene["k4_on_bound"]),
        ("K5", "render_frame, render_cli and orbit frames", dense_launches, k5_ms, k5_bound),
    ] + ooc_sites + mesh_sites + train_sites + k3_sites + [
        ("K1", "render_store_grid_sharded, render_cli --mesh and the sharded service", apps_k1,
         *mesh_sites[0][3:]),
    ] + exact_set["sites"] + [
        ("A1", "step_optimizer, the store trainer's fit (512^3 store, pin; its TF's launches "
         "aside)", TRAIN_STEPS, *adam_ms["pin"]),
        ("A1", "step_optimizer, the exact trainer (512^3 density; its TF's launches aside)",
         len(EXACT_TRAIN_ORDER), *adam_ms["none"]),
    ]
    print(f"launch sites on the main paths: launches, ms per launch on the site's operands, "
          f"bound, launches x (ms - bound) {card}")
    above = {}
    for kernel, site, n, site_ms, (b_ms, b_by) in sites:
        above[kernel] = above.get(kernel, 0.0) + n * (site_ms - b_ms)
        print(f"  {kernel} {site}: {n} launches, {site_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{n * (site_ms - b_ms):.3f} ms")
    print("  by kernel: " + "; ".join(f"{k} {v:.3f} ms" for k, v in
                                      sorted(above.items(), key=lambda kv: -kv[1])))

    print(json.dumps({"kernels": [
        {
            "name": "post_sweep",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/post_sweep.cu",
            "replaces": "libre_tpu/ops/shearwarp_bricked.py:78",
            "launches": launches + train_fwd_launches + ooc_launches + serve_k1
            + scripts["post_sweep"] + mesh_k1 + train_k1 + apps_k1 + p31_launches["post_sweep"],
            "max_abs_err": max(max_err, ooc_err, script_errs["post_sweep"],
                               p31_errs["post_sweep"]),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
        },
        {
            "name": "store_grid_bwd",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/store_grid_bwd.cu",
            "replaces": "libre_tpu/ops/shearwarp_grad.py:440",
            "launches": render_bwd_launches + train_bwd_launches + scripts["store_grid_bwd"]
            + train_k2,
            "max_abs_err": max(bwd_err, script_errs["store_grid_bwd"], mesh_k2_err),
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
        },
        {
            "name": "exact_march",
            "instance": "fixed (T = 256)",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/exact_march.cu",
            "replaces": "libre_tpu/ops/exact_pallas.py:481",
            "launches": exact_launches + ex_fwd_launches + serve_k3 + scene["k3_launches"]
            + entry_k3 + scripts["exact_march"] + mesh_k3 + exact_set["k3_launches"]
            + p31_launches["exact_march"],
            "max_abs_err": max(k3_err, k3_train_err, scene["k3_err"], entry_err,
                               script_errs["exact_march"], exact_set["k3_err"],
                               p31_errs["exact_march"]),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
        {
            "name": "exact_march_bwd",
            "instance": "fixed (T = 256)",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/exact_march_bwd.cu",
            "replaces": "libre_tpu/ops/exact_pallas.py:1405",
            "launches": ex_bwd_launches + scene["k4_launches"] + scripts["exact_march_bwd"]
            + exact_set["k4_launches"] + p31_launches["exact_march_bwd"],
            "max_abs_err": max(k4_err, scene["k4_err"], script_errs["exact_march_bwd"],
                               exact_set["k4_err"], p31_errs["exact_march_bwd"]),
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1],
            "library_ms": None,
        },
        {
            "name": "pre_sweep",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/pre_sweep.cu",
            "replaces": "libre_tpu/ops/shearwarp_pallas.py:206",
            "launches": dense_launches + p31_launches["pre_sweep"],
            "max_abs_err": max(k5_err, p31_errs["pre_sweep"]),
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound[0],
            "bound_by": k5_bound[1],
            "library_ms": None,
        },
    ] + p31_instances + probe_entries + [adam_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
