#!/usr/bin/env python3
"""Correctness sweep of the PyTorch port (libre_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Every hand-written kernel is held against its plain PyTorch version, and
every main path is run end to end with its kernels' launches counted.
Times are not taken here: the benchmark (``perfbench/run.py``) measures
the port.  Phases, each of which raises on failure (any failure exits
non-zero):

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
5. kernel vs plain on the main path's own operands, bit-equal, with the
   plain plane lists a superset of each tile's fetches, the same for the
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
   per view; a checkpoint round trip; the backward kernel vs plain on
   view 0 over the trained store and over the truth store; K1 on view 0
   bit-equal to plain;
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
   the last frame rebuilt from its operands, and again from only the
   bricks some ray samples;
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
   ``render_exact_diff`` on the card vs the plain backward;
13. the exact training path at full width: ``init_exact_state`` from a
   flat 0.5 volume, ``make_exact_train_step`` with Adam (lr 5e-2) for 5
   steps over 4 views (512² rays, 512 samples per ray, trilinear) of a
   512³ smooth ground truth; K3 and K4 must launch once per step and the
   loss of view 0 must fall; K4 vs plain on the whole of view 0 over the
   trained volume and over the ground truth (three seeded cotangents, K4
   twice on each, its TF gradient also against the plain version over
   float64 operands); K3 (with its sample counts) and K4 vs plain on a
   64×64 window of it;
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
   version may run; K5 bit-equal to plain on the last pose's operands,
   with its plane lists;
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
   PyTorch library call; the four kernels' launch counts set to 0 before
   and read after;
20. the interactive service (``phase_serve``): ``RenderService`` on the
   512³ volume at 512×512 driven over HTTP on 127.0.0.1 (orbit, colormap,
   the exact renderer, the 2×2 layout through the wall, an asynchronous
   frame), K1's and
   K3's counts set to 0 before and read after; each served frame
   bit-equal to the engine's own frame, each histogram equal to numpy's
   bincount over the frame's bricks;
21. the dense shear-warp trainer at full width (``phase_dense_trainer``):
   ``train.shearwarp_trainer`` over a 256³ smooth truth with
   ``ShearWarpParams``' defaults (K = 256, 256² slope grids), 4 views,
   5 Adam steps ("post") and 2 ("pre"), the plain pipeline (batched
   products, no kernel); the TF gather's ``bincount`` backward against
   autograd's indexing in ``render_slope_grid_fused`` at full width;
   card vs CPU on a 32³ problem;
22. ``models.VolumeScene`` at full width (``phase_scene``): a 512³
   smooth volume, 512² rays, the early exit 0.999: the target's render
   and 5 Adam steps on the estimate's MSE, with K3's and K4's counts set
   to 0 before and read after and the plain marcher made to raise; K3
   and K4 (with the exit rule) vs plain on a 64×64 window, K4 on every
   field of ``testing.FIELDS`` with the rays that exit counted; the 16³
   test scene on the card vs the CPU;
23. the benchmark scripts (``phase_scripts``): ``bench_forward --quick``,
   ``probe_bwd_breakdown``, ``demo_inverse_render`` (store and
   ``--exact``) and ``demo_out_of_core`` cut to 512³, each ``python -m``
   in its own process, each holding one call of every kernel it runs
   against the kernel's plain version; their launch counts and largest
   errors go into the kernels line;
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
   same set with the early exit on; each K4 call (512 and 256 bricks)
   held against the plain version on a 64x64 window of its rays;
31. what finished the one-card port (``phase_finish``): K3 and K4 through
   their runtime-T instances at T = 1, 32 and 1024 against their plain
   versions on a 64x64 window of phase 13's view 0; then, with the counts
   set to 0 before and read after, 5 Adam steps of the exact trainer from
   a 32-entry TF, the 1x2 and 2x2 walls of ``RenderService`` at 512x512
   through ``render_wall`` and the sequential loop, 2x2 requests over
   HTTP through the wall and through the loop, and the bf16 store frame
   (K1) and dense frame (K5); every wall tile and served canvas bit-equal
   to the loop's, the bf16 launches bit-equal to plain;
   ``benchmarks/demo_wall`` at its defaults;
32. the trainers' update (``phase_adam``): ``train.update.step_optimizer``
   over a 512³ leaf and a (256, 4) TF through ``csrc/adam_update.cu`` (one
   launch a leaf, no fallback), each epilogue held to ``torch.optim.Adam``
   plus the old epilogue over 5 steps within ``testing.ADAM_TOL_ULPS``.
   The trainers' runs on the card (dense, sharded store, exact set,
   exact and store trainers) and these checked steps count the kernel's
   launches from 0 and raise on a fallback (``adam_counted``); the
   ``kernels`` line sums those counts.

Prints one JSON line describing the kernels (each kernel's launches on
the main paths and its largest error against its plain version), then,
as the last line, ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when no CUDA device is present.
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
# The exact trainer's views: benchmarks/demo_inverse_render.py:34-37.
EXACT_EYES = ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3], [0.02, -0.12, 1.5], [-0.05, -0.02, 1.2])
EXACT_TRAIN_N = 512
EXACT_TRAIN_ORDER = (0, 1, 2, 3, 0)
# The gather probes (benchmarks/probe_*.py, ported as libre_tpu_torch/benchmarks
# on ops/gather.py), in the order their modules run them.
PROBES = ("P1", "P2", "P3", "P4", "P5", "P6", "P7", "P8", "P9", "P10 axis 1", "P10 axis 0",
          "P11", "P12", "P13", "P14", "P15", "P16", "P17")


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


def k1_plain(store, tf, tables, clip, kw):
    """The plain sweep on K1's operands: (out, t_out, and the (TV, TU, K)
    tiles' planes at which some ray fetches)."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb

    v_size, u_size = tables.corr.shape
    rows, cols = swb.SWEEP_TILE
    fetches = torch.zeros((-(-v_size // rows), -(-u_size // cols), tables.a0.shape[0]),
                          dtype=torch.bool, device=store.device)
    want, t_want = swb.post_sweep_reference(store, tf, tables, clip, fetches=fetches, **kw)
    return want, t_want, fetches


def check_k1_again(calls, what):
    """The last recorded K1 launch of ``calls`` ((name, args) of a
    ``Recorder``) at a sharded call site, launched again on its operands
    as they are now (a training step's optimizer has updated the TF in
    place since): bit-equal to the plain sweep on them."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb

    args = [a for name, a in calls if name == "post_sweep"][-1]
    ops, _recorded = k1_operands(args)
    out, t_out = swb.post_sweep(*ops[:4], **ops[4])
    want, t_want, _fetches = k1_plain(*ops)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(t_out, t_want)):
        raise AssertionError(f"{what}: K1 is not bit-equal to the plain sweep")
    print(f"  K1 at {what}: {tuple(out.shape)} rays x {ops[2].a0.shape[0]} planes over "
          f"{tuple(ops[0].shape)}, bit-equal to plain")


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


def phase_out_of_core(dev, card):
    """18. The out-of-core slab multipass and the upload pipeline on the
    reference's own out-of-core demo size (benchmarks/demo_out_of_core.py,
    OOC_RUN_r05.json): a 1024^3 uint8 volume in 64^3 bricks, rendered at
    its finest level (4096 bricks, a 4 GiB store).  ``render_cli`` at the
    default 3072 MB budget; an 8-pose orbit at 512 MB (two warm laps, a
    checked one) against the same orbit in core, bit for bit; the
    asynchronous ``render_bricked`` and ``render`` on cold engines; and
    ``upload_view`` behind a frame's kernels.  Bricks are generated once,
    by the CLI frame, and served from a memo to the later engines.
    Returns (K1 launches on its main paths, K1's max |d| against plain)."""
    import torch

    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.data import memory
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
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
            rc = render_cli.main([
                "--volume", OOC_URI, "--width", "512", "--height", "512",
                "--min-lod", str(OOC_FINEST), "--output-dir", out_dir,
            ])
            torch.cuda.synchronize()
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
              f"{budget} B derived budget, {n_passes} slab passes, {cli_launches} K1 launches")
        cli_ops, (cli_out, cli_t) = k1_operands(k1_cli.calls[0][1])
        want, t_want, _fetches = k1_plain(*cli_ops)
        torch.cuda.synchronize()
        if not (torch.equal(cli_out, want) and torch.equal(cli_t, t_want)):
            raise AssertionError("render_cli at 1024^3, pass 1: K1 is not bit-equal to plain")
        del k1_cli, cli_ops, cli_out, cli_t, want, t_want, _fetches
        free_device_memory()
        print(f"phase 18, CLI frame: {time.perf_counter() - t_phase:.1f} s")

        # ------------------------------------------- the out-of-core orbit
        poses = orbit_cameras()
        kw = dict(screen_space_error=1.0, min_lod=OOC_FINEST)
        ooc = RenderEngine(DataSource(OOC_URI), max_gpu_cache_mb=OOC_MB, device=dev)
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
        rows, ooc_frames = [], []
        evictions = ooc.texture_cache.statistics.evictions
        swb.post_sweep.launches = 0
        plain_calls.clear()
        for i, (camera, frustum) in enumerate(poses):
            passes.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            at_start = torch.cuda.memory_allocated(dev)
            before = swb.post_sweep.launches
            img, stats = ooc.render_bricked(camera, frustum, **kw)
            torch.cuda.synchronize()
            ev = ooc.texture_cache.statistics.evictions
            rows.append(dict(passes=stats.n_passes, nonempty=sum(1 for p in passes if p),
                             launches=swb.post_sweep.launches - before, evicted=ev - evictions,
                             peak=torch.cuda.max_memory_allocated(dev), at_start=at_start))
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
            print(f"  out-of-core frame {i}: {r['passes']} passes ({r['nonempty']} with bricks, "
                  f"as many K1 launches), {r['evicted']} evictions; peak allocated {r['peak']} B, "
                  f"{r['peak'] - r['at_start']} B above the frame's start")
        print(f"out-of-core orbit at {OOC_MB} MB ({ooc.atlas.n_slots}-slot atlas, "
              f"{ooc.device_budget.budget} B derived budget): peak allocated above a frame's "
              f"start {max(r['peak'] - r['at_start'] for r in rows)} B against the {OOC_MB} MB "
              f"budget {card}")
        print(f"phase 18, out-of-core orbit: {time.perf_counter() - t_phase:.1f} s")

        # K1 on every pass of the last frame, bit-equal to plain.
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
        for _name, args in k1_ooc.calls:
            ops, (out, t_out) = k1_operands(args)
            want, t_want, _fetches = k1_plain(*ops)
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(t_out, t_want)):
                raise AssertionError("an out-of-core pass: K1 is not bit-equal to plain")
            del ops, out, t_out, want, t_want, _fetches
        print(f"K1 on the {len(k1_ooc.calls)} passes of the last out-of-core frame: each "
              f"bit-equal to plain")
        del k1_ooc

        # upload_view for the next pose behind the current frame's kernels.
        ooc.render_bricked(poses[0][0], poses[0][1], **kw)
        n_up = ooc.upload_view(poses[1][1], 512, **kw)
        torch.cuda.synchronize()
        print(f"upload_view of pose 1 after pose 0's frame was enqueued: {n_up} bricks")
        del ooc, last
        free_device_memory()

        # ------------------------------------------------ the in-core orbit
        incore = RenderEngine(DataSource(OOC_URI), max_gpu_cache_mb=INCORE_MB, device=dev)
        slab_frames.clear()
        for camera, frustum in poses:
            incore.render_bricked(camera, frustum, **kw)
        torch.cuda.synchronize()
        for i, (camera, frustum) in enumerate(poses):
            img, stats = incore.render_bricked(camera, frustum, **kw)
            torch.cuda.synchronize()
            if stats.n_passes != 1 or not torch.equal(img, ooc_frames[i]):
                raise AssertionError(f"pose {i}: the out-of-core frame is not the in-core frame "
                                     f"bit for bit ({stats.n_passes} in-core passes)")
        if slab_frames:
            raise AssertionError("the in-core orbit went out of core")
        print(f"in-core orbit at {INCORE_MB} MB: every out-of-core frame bit-equal to its "
              f"in-core frame")
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
            for f in futures:
                f.result()
            if frames < 2 or not torch.equal(img, want):
                raise AssertionError(f"async {method}: {frames} frames; the last is not the "
                                     f"synchronous frame bit for bit")
            under = " under a side stream" if stream is not None else ""
            print(f"async {method}{under} on a cold engine: done after {frames} frames "
                  f"({len(futures)} upload batches); the last frame bit-equal to the "
                  f"synchronous default-stream one")
            del cold, out, img, stats, futures
            free_device_memory()
    finally:
        memory.MemoryDataSource.get_data = real_get_data
        RenderEngine._render_slabs = real_render_slabs
        swb.post_sweep_reference = real_plain
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return cli_launches + orbit_launches, 0.0


def phase_probes(dev, card):
    """19. The gather probes P1-P17 through the port's own entry points
    (``python -m libre_tpu_torch.benchmarks.<module>``'s ``main``) at
    their full shapes: each probe's kernel bit-equal to its plain version
    and its library call (``_probe.run`` raises otherwise).  The four
    gather kernels' counts are set to 0 just before and read just after;
    each must have launched, as often as its probes say.  Then the kernel
    instances no probe reaches, each once, bit-equal to its plain version:
    the nearest lookup's scalar instance (a C = 3 table; densities 4 B past
    an aligned start), the loop sum too large to stage (either axis), and
    the NaN fill for a table with no entry along the axis (where the plain
    version raises).  Returns the probes' entries of the ``kernels``
    line."""
    import importlib

    import torch

    from libre_tpu_torch.benchmarks import MODULES
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
    if [r["probe"] for r in results] != list(PROBES):
        raise AssertionError(f"probes {[r['probe'] for r in results]} vs {list(PROBES)}")
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
    entries = [{
        "name": r["kernel"],
        "probe": r["probe"],
        "route": "cuda",
        "source": f"libre_tpu_torch/csrc/{r['kernel']}.cu",
        "replaces": r["replaces"],
        "launches": r["launches"],
        "max_abs_err": r["max_abs_err"],
    } for r in results]
    print("  launches: " + "; ".join(f"{k} {n}" for k, n in counts.items()))
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
    (K1 launches, K3 launches)."""
    import urllib.request

    import torch

    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops import shearwarp_bricked as swb

    t_phase = time.perf_counter()
    svc = RenderService(uri, width=size, height=size, host="127.0.0.1", port=0, device=dev)
    engine = svc.engine
    served, hist_calls = [], []
    real_frame, real_hist = svc.render_frame, engine.accumulate_histogram

    def render_frame(progressive=False):
        canvas = real_frame(progressive)
        served.append(dict(
            canvas=canvas, mv=svc.frame_data.camera_settings.get_modelview_matrix().copy(),
            color_map=np.array(svc.frame_data.render_settings.color_map),
            params=dict(svc.server.params), layout=svc.layout, hist=svc._histogram,
            sets=[]))
        return canvas

    def accumulate_histogram(nodes, *args):
        hist_calls.append(list(nodes))
        return real_hist(nodes, *args)

    svc.render_frame, engine.accumulate_histogram = render_frame, accumulate_histogram
    svc.server.start()
    host, port = svc.server.address
    base = f"http://{host}:{port}"

    def call(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=300) as resp:
            raw = resp.read()
            return json.loads(raw) if "json" in resp.headers.get("Content-Type", "") else raw

    hists, steps = [], []

    def frame(step):
        n_hist = len(hist_calls)
        jpeg = call("/image-jpeg", "POST", {})
        if jpeg[:2] != b"\xff\xd8":
            raise AssertionError(f"serve {step}: /image-jpeg gave no JPEG")
        hists.append(call("/histogram"))
        served[-1]["sets"] = hist_calls[n_hist:]
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
        svc.render_frame, engine.accumulate_histogram = real_frame, real_hist
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
    del svc, engine, served
    free_device_memory()
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return k1, k3


# ------------------------------------------------------------- phases 21-24
DENSE_TRAIN_N = 256  # phase 21: the truth's size, ShearWarpParams' defaults (K = 256, 256^2 grids)
DENSE_TRAIN_STEPS = 5
DENSE_PRE_STEPS = 2
SCENE_N = 512  # phase 22: the scene's volume, SCENE_RAYS^2 rays, the scene's default params
SCENE_RAYS = 512
SCENE_EXIT = 0.999  # its early exit (RenderParams' default)
SCENE_STEPS = 5  # Adam steps (lr SCENE_LR) on its MSE
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
    grayscale TF; the loss must fall and the leaves stay in [0, 1]; "pre"
    for 2 steps; the TF gather's backward by bincount against autograd's
    indexing in ``render_slope_grid_fused`` at full width, gradients
    within ``DENSE_GRAD_TOL``; card vs CPU on a 32^3 / 32^2 problem, loss
    and one Adam step's leaves within 1e-4.  The trainer runs the plain
    pipeline (batched products): no kernel of the port but the update's."""
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
    for classification, n_steps in (("post", DENSE_TRAIN_STEPS), ("pre", DENSE_PRE_STEPS)):
        prob = problem(classification)
        with torch.no_grad():
            targets = prob.render_views(None, truth, tf_true)
        leaves, opt = start(truth.shape, dev)
        step = make_shearwarp_train_step(prob, opt)
        with adam_counted(f"dense trainer ({classification})", 2 * n_steps):
            losses = [float(step(leaves, targets)) for _ in range(n_steps)]
        print(
            f"dense trainer ({classification}): {DENSE_TRAIN_N}^3, K = {prob.swp.n_planes}, "
            f"{len(prob.plans)} views of {prob.swp.inter_size} slope rays, {n_steps} Adam steps;"
            f" losses {losses} {card}"
        )
        if not all(np.isfinite(losses)):
            raise AssertionError(f"dense trainer ({classification}): losses {losses}")
        for k, v in leaves.items():
            if float(v.detach().min()) < 0.0 or float(v.detach().max()) > 1.0:
                raise AssertionError(f"dense trainer ({classification}): {k} left [0, 1]")
        if classification == "post" and not losses[-1] < losses[0]:
            raise AssertionError(f"dense trainer did not lower its loss: {losses}")
        del targets, leaves, opt, step

    # The TF gather's backward (``transfer_function._TakeRows``, by
    # bincount) against autograd's own backward of ``table[idx]``, which it
    # replaced: ``render_slope_grid_fused`` (K5 forward, the recompute
    # backward of the plain pipeline, as the trainer's) over the truth from
    # view 0 at full width, its gradients held against each other.
    pre = problem("pre")
    pa = swd.slope_grid_plan_args(pre.plans[0], gmin, gmax, pre.params, pre.swp)
    g = torch.randn(pre.swp.inter_size + (4,), generator=torch.Generator().manual_seed(2))

    def fused_grads():
        leaves = [truth.clone().requires_grad_(), tf_true.clone().requires_grad_()]
        return torch.autograd.grad(swd.render_slope_grid_fused(*leaves, pa), leaves, g.to(dev))

    class Indexing:
        apply = staticmethod(lambda table, idx: table[idx])

    take_rows, got = tfm._TakeRows, {}
    got["bincount"] = fused_grads()
    tfm._TakeRows = Indexing
    try:
        got["indexing"] = fused_grads()
    finally:
        tfm._TakeRows = take_rows
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


def phase_scene(dev, card, exact_tol):
    """22. ``VolumeScene`` at full width: a 512^3 smooth volume, 512^2
    rays, the scene's default params (512 samples per ray, trilinear, the
    early exit 0.999).  The main path: K3's and K4's counts set to 0, the
    plain marcher's functions made to raise, then the target's render and
    ``SCENE_STEPS`` Adam steps on the estimate, each its render,
    ``torch.autograd`` of the MSE (K3 once, K4 once, with the exit rule),
    the update and a clamp to [0, 1]; the loss must fall and the last
    gradients be finite and non-zero.  Then, off the main path: K3 vs
    plain on a 64x64 window of the view, K4 with the exit rule vs plain on
    that window over every field of ``testing.FIELDS`` (the backward
    kernels' early-exit bound, rays that exit counted), and the 16^3 /
    24^2 test scene on the card vs the CPU.  Returns the counts and errors
    for the ``kernels`` line."""
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
        losses = []
        for _ in range(SCENE_STEPS):
            opt.zero_grad()
            img = scene.with_parameters(leaves).render(camera)
            loss = torch.mean((img - target) ** 2)
            loss.backward()
            opt.step()
            with torch.no_grad():
                for v in leaves.values():
                    v.clamp_(0.0, 1.0)
            losses.append(float(loss.detach()))
    finally:
        exact.march_exact_reference, exact.march_exact_backward_reference = plain
    k3_launches, k4_launches = exact.march_exact.launches, exact.march_exact_backward.launches
    # ----------------------------------- end of the scene's main path
    exits = int((img.detach()[..., 3] > SCENE_EXIT).sum())
    print(
        f"VolumeScene: {SCENE_N}^3, {SCENE_RAYS}^2 rays, 512 samples per ray, trilinear, early exit "
        f"{SCENE_EXIT}, {SCENE_STEPS} Adam steps (lr {SCENE_LR}): losses {losses}; K3 launches "
        f"{k3_launches}, K4 launches {k4_launches}; {exits} of {img.shape[0] * img.shape[1]} rays "
        f"exit {card}"
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
                k4_err=k4_err)


def phase_scripts(card):
    """23. The benchmark scripts (``libre_tpu_torch/benchmarks``), each
    ``python -m`` in a process of its own (``SCRIPT_RUNS``).  Each script
    holds one call of every kernel it runs against its plain version on
    the same inputs, and exits non-zero past the kernel's bound; its
    output's last two lines give those checks' largest errors and its
    render kernels' launch counts (the checks' launches not counted), and
    a kernel it launched must have been checked.  ``demo_out_of_core``
    writes into a temporary directory, and its record must have the
    reference's keys.  Returns the summed launch counts and the largest
    errors, by kernel."""
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
    plain march on the same inputs on the CPU."""
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


def check_k2(calls, what):
    """The last recorded K2 launch of ``calls`` at a sharded training
    step: within the backward kernels' bound of the plain backward on its
    operands (early exit off) → max |d|."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_grad as swg

    args = [a for name, a in calls if name == "store_grid_bwd"][-1]
    (store, tf, a0, a1, wa, dl, act, view, corr, rgb_in, t_in, out, t_out, g, _ds, _dtf,
     _k, _nc, _nb, _v, _u, diff_tf, wb0, wb1, wc0, wc1, _sb, _sc, early_exit) = args
    tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=view, corr=corr,
                             rgb_in=rgb_in, t_in=t_in)
    kw = dict(wb=(wb0, wb1), wc=(wc0, wc1), early_exit=early_exit, diff_tf=bool(diff_tf))
    store, tf = store.detach(), tf.detach()  # the recorded training leaves
    got = swg.store_grid_backward(store, tf, tables, out, t_out, g, **kw)
    want = swg.store_grid_backward_reference(store, tf, tables, out, t_out, g, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        compare_grads(a, b, f"{what}, K2 gradient {i} vs plain", early_exit)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


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
    below 2e-3 (0.999).  Then one shard's K1 of a 2x2 frame bit-equal to
    plain.  Returns the K1 launches."""
    import torch

    from libre_tpu_torch.data.datasource import DataSource
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.testing import SHARD_TOL_EXIT_OFF, SHARD_TOL_EXIT_ON

    params = {e: RenderParams(n_samples_per_ray=512, data_source_range=engine.data_source_range,
                              early_exit=e) for e in MESH_EXITS}
    kw = dict(screen_space_error=1.0)
    engine.mesh = None
    refs = {e: [engine.render_bricked(cam, fr, params=params[e], **kw)[0] for cam, fr in poses]
            for e in MESH_EXITS}
    slab_engine = RenderEngine(DataSource(URI), max_gpu_cache_mb=SLAB_MB, device=dev)
    launches = 0
    for mode, eng in (("replicated", engine), ("slabs", slab_engine)):
        for n_brick, n_ray in MESH_SHAPES:
            eng.mesh = logical_mesh(dev, n_brick, n_ray)
            for e in MESH_EXITS:
                tol = SHARD_TOL_EXIT_OFF if e > 1.0 else SHARD_TOL_EXIT_ON
                torch.cuda.synchronize()
                swb.post_sweep.launches = 0
                eng.sharded_frames = 0
                errs = []
                for (cam, fr), ref in zip(poses, refs[e]):
                    img, stats = eng.render_bricked(cam, fr, params=params[e], **kw)
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
                print(f"sharded orbit, {mode} store, (brick, ray) = ({n_brick}, {n_ray}), exit {e}: "
                      f"{n_sharded} sharded frames, {n_k1} K1 launches; max|d| vs one device "
                      f"{max(errs):.3e} (bound {tol}) {card}")
            if mode == "replicated" and (n_brick, n_ray) == MESH_SHAPES[0]:
                cam, fr = poses[-1]
                with Recorder("post_sweep") as rec:
                    eng.render_bricked(cam, fr, params=params[1.1], **kw)
                check_k1_again(rec.calls, "a shard of the 2x2 orbit frame")
    engine.mesh = None
    del slab_engine
    free_device_memory()
    return launches


def phase_sharded_training(dev, card, problem, store, tf, targets):
    """26. Phase 7's store trainer over logical shards of the card: its 4
    views (one major axis and one march sign: the orbit's), 512^2 slope
    grids, K = 512, over the orbit's 512^3 store.  From the flat init, the
    loss and its store and TF gradients of the views x rows loss on a 2x2
    mesh and of the slab loss on n_brick = 2 and 4 against the one-device
    loss (rtol 1e-6) and gradients (1e-5); then ``SHARD_TRAIN_STEPS`` Adam
    steps of each (lr 5e-2), K1's and K2's counts set to 0 just before
    and read just after: the loss falls, K1 and K2 launch once per view
    per ray shard per brick shard of the view's; a slab shard's last K1
    and K2 against plain.  Returns (K1, K2 launches, K2 max |d|)."""
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
        losses = []
        # The last step of the 4-slab run records its launches' operands
        # (recording every step would hold each launch's slab and d_store).
        rec = Recorder("post_sweep", "store_grid_bwd")
        with adam_counted(name, (len(leaves) + 1) * SHARD_TRAIN_STEPS):
            for i in range(SHARD_TRAIN_STEPS):
                last = slabs and n_brick == 4 and i == SHARD_TRAIN_STEPS - 1
                with rec if last else contextlib.nullcontext():
                    losses.append(float(step(params, targets)))
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
        print(f"{name}: {SHARD_TRAIN_STEPS} Adam steps, losses {losses}; K1 {n_k1 // SHARD_TRAIN_STEPS} "
              f"and K2 {n_k2 // SHARD_TRAIN_STEPS} launches a step {card}")
        if slabs and n_brick == 4:
            check_k1_again(rec.calls, "a slab shard's forward (n_brick 4)")
            k2_err = check_k2(rec.calls, "a slab shard's backward (n_brick 4)")
        del leaves, tf_p, params, step, rec
        free_device_memory()
    return k1_total, k2_total, k2_err


def phase_sharded_exact(dev, card, exact_tol):
    """27. ``VolumeScene.render_sharded`` at phase 22's width (a 512^3
    smooth volume, 512^2 rays, its default params) on a 2x2 mesh of
    logical shards against ``render``: K3's count set to 0 before and read
    after, once per shard (one pass each); the image within K3's bound.
    Returns the K3 launches."""
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
        got = scene.render_sharded(mesh, camera)
        torch.cuda.synchronize()
        launches = exact.march_exact.launches
        # --------------------------------------------- end of the main path
        if launches != 4:
            raise AssertionError(f"render_sharded launched K3 {launches} times, want 4")
        compare(got, one, "VolumeScene.render_sharded (2x2) vs render", exact_tol)
    return launches


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
        for i, (_cam, frustum) in enumerate(poses):
            call("/camera", "PUT", {"modelview": frustum.mv.tolist()})
            if call("/image-jpeg", "POST", {})[:2] != b"\xff\xd8":
                raise AssertionError(f"sharded service pose {i}: no JPEG")
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
          f"to the engine's sharded frames {card}")
    return launches


def phase_two_process(dev, card):
    """29. Two processes on this machine, each on the card, in one gloo
    group (``parallel/two_process.py`` at 256^3 / 256^2 rays / 512
    planes): the frame-state broadcast, the rows gathered across the
    processes against the one-device grid, the summed slab loss and TF
    gradient (``all_reduce``) against the one-device ones."""
    from libre_tpu_torch.parallel import two_process

    outs = two_process.run(str(dev), vox=TWO_PROCESS_N, img=TWO_PROCESS_N, timeout=300)
    for rank, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"OK rank={rank} "))
        print(f"two processes, rank {rank}: {line.split(' ', 2)[2]} {card}")


SET_SPLIT = 8  # phase 30: the 512^3 smooth truth in 8^3 bricks of 64^3, two ghost voxels
SET_STEPS = 5
SET_LR = 1e-2


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
    per shard and step); the loss must fall, and the first 2x2 step's loss
    and gradients agree with the 1x1 step's (loss rtol
    ``SHARD_LOSS_RTOL``, gradients within the exit-off backward bound of
    the largest entry); then ``VolumeScene.render`` over the same set with
    the early exit on (0.999): the target's render, one forward and
    backward of the estimate's MSE (K3 twice, K4 once).  Off the main
    path: each K4 call (the 1x1 trainer over 512 bricks, one 2x2 shard
    over 256, the scene over 512) held against the plain version on a
    64x64 window of its rays; K3 on the 1x1 trainer's window.  Returns the
    counts and errors for the ``kernels`` line."""
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
          f"{SCENE_RAYS}^2 rays, max_steps {problem.max_steps}")
    adam = functools.partial(torch.optim.Adam, lr=SET_LR)
    runs, k3_launches, k4_launches = {}, 0, 0
    for n_brick, n_ray in ((1, 1), (2, 2)):
        mesh = logical_mesh(dev, n_brick, n_ray)
        state = init_state(start, grayscale_ramp(), adam, mesh=mesh)
        step = make_train_step(start, adam, mesh)
        losses, first = [], None
        torch.cuda.synchronize()
        exact.march_exact.launches = exact.march_exact_backward.launches = 0
        n_leaves = sum(len(g["params"]) for g in state.optimizer.param_groups)
        with captured(exact, "march_exact_backward") as calls, adam_counted(
                f"exact set trainer ({n_ray}x{n_brick})", n_leaves * SET_STEPS):
            for i in range(SET_STEPS):
                losses.append(float(step(state, eye, dirs, tnp, target)))
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
        print(f"exact set trainer on a {n_ray}x{n_brick} mesh: {SET_STEPS} Adam steps (lr "
              f"{SET_LR}): losses {losses}; K3 {counts[0]}, K4 {counts[1]} launches {card}")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"the exact set trainer's loss did not fall: {losses}")
        runs[(n_brick, n_ray)] = dict(losses=losses, first=first, call=calls[-1])
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
        with torch.no_grad():
            scene_target = scene.render(camera)
        img = scene.with_parameters(leaves).render(camera)
        loss = torch.mean((img - scene_target) ** 2)
        loss.backward()
        scene_loss = float(loss.detach())
    scene_counts = (exact.march_exact.launches, exact.march_exact_backward.launches)
    # --------------------------------------------- end of the scene's main path
    exits = int((img.detach()[..., 3] > SCENE_EXIT).sum())
    print(f"VolumeScene over {sharded.num_bricks} bricks, early exit {SCENE_EXIT}: target, "
          f"forward and backward: loss {scene_loss:.6f}; {exits} of {img.shape[0] * img.shape[1]} "
          f"rays exit; K3 {scene_counts[0]}, K4 {scene_counts[1]} launches {card}")
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

    # Off the main path: each K4 call against plain on a window.
    k4_err = 0.0
    for seed, (what, call) in enumerate((
            ("the 1x1 exact set trainer", one["call"]),
            ("one shard of the 2x2 exact set trainer", four["call"]),
            ("VolumeScene over the set, exit on", scene_calls[-1]))):
        what = f"{what} ({call[0][0].shape[0]} bricks)"
        k4_err = max(k4_err, k4_set_window(call, what, seed))
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
                k4_err=k4_err)


# ------------------------------------------------------------------ phase 31
# Phase 31: K3 and K4 through their runtime-T instances, shared (T <= 4096)
# and global (past it: a 65 536-entry TF is what a .1dt file of a uint16
# volume's value range holds).
FINISH_TF_SIZES = (1, 32, 1024, 4096, 8192, 65536)
FINISH_TRAIN_TF = 32  # the exact trainer's TF in phase 31, as the JAX trainer's tests and dry run
FINISH_STEPS = 5
FINISH_WIDE_TF = 8192  # a TF past the shared instances: trainer steps and one xla frame
FINISH_WIDE_STEPS = 2
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


def phase_finish(dev, card, exact_tol, view, engine, pose, dense, size=512):
    """31. What finished the one-card port: K3 and K4 at any TF size, the
    multi-view wall, the bf16 resample of K1 and K5.

    Checks first: K3 and K4 through their runtime-T instances at T in
    ``FINISH_TF_SIZES`` against their plain versions on a ``SUBSET`` x
    ``SUBSET`` window of phase 13's training view 0 over its 512^3 smooth
    truth (the tolerances of phases 10 and 13; at T = 1 the density
    gradient is zero in both).  Then the main path, with the five render
    kernels' counts set to 0 just before and read just after: 5 Adam
    steps of the exact trainer from a 32-entry TF on view 0; the 1x2 and
    2x2 walls of ``RenderService`` at 512x512 on phase 20's volume and
    screen-space error, ``render_wall`` and the sequential
    ``render_bricked`` loop; ``WALL_REQUESTS`` 2x2 requests over HTTP
    through the wall and as many through the loop; the bf16 store frame
    (``render_store_frame``) on phase 4's last pose and the bf16 dense
    frame (``render_frame``) on phase 16's.  Then: every wall tile and
    every wall-served canvas bit-equal to the loop's frames, the bf16
    launches bit-equal to their plain versions (``compute_dtype=
    "bfloat16"``) and each bf16 frame's distance from its f32 frame;
    ``benchmarks/demo_wall`` at its defaults in a process of its own.
    Returns the phase's launches and largest errors by kernel, and the
    runtime-T instances' entries of the ``kernels`` line."""
    import urllib.request

    import torch

    from libre_tpu_torch.apps.serve import RenderService
    from libre_tpu_torch.ops import exact
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

    inst_errs = {}
    for n_tf in FINISH_TF_SIZES:
        kind = exact.tf_instance(n_tf)
        tf = torch.from_numpy(tf_of_size(n_tf)).to(dev)
        what = f"T = {n_tf}, {SUBSET}x{SUBSET} window of training view 0"
        out_w = exact.march_exact(*k3_args(tf, win), max_steps=win.max_steps, width=SUBSET)
        want_w = exact.march_exact_reference(*k3_args(tf, win), max_steps=win.max_steps)
        torch.cuda.synchronize()
        k3_err = compare(out_w, want_w, f"K3, {what}", exact_tol)
        got = exact.march_exact_backward(gt, tf, win, out_w, g_win)
        want = exact.march_exact_backward_reference(gt, tf, win, out_w, g_win)
        torch.cuda.synchronize()
        k4_err = 0.0
        for name, a, b in zip(("d_volume", "d_tf"), got, want):
            compare_grads(a, b, f"K4, {what}: {name}", 1.1, EXACT_GRAD_TOL_MAX,
                          expect_zero=n_tf == 1 and name == "d_volume")
            k4_err = max(k4_err, float((a - b).abs().max()))
        errs["exact_march"] = max(errs["exact_march"], k3_err)
        errs["exact_march_bwd"] = max(errs["exact_march_bwd"], k4_err)
        old = inst_errs.get(kind, (0.0, 0.0))
        inst_errs[kind] = (max(old[0], k3_err), max(old[1], k4_err))

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
        return [], "served as the sequential loop"

    svc.render_frame = render_frame
    svc.server.start()
    host, port = svc.server.address
    base = f"http://{host}:{port}"

    def call(path, method="GET", body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(base + path, data=data, method=method)
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.read()

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
            walls[layout] = dict(
                views=views, wall=seng.render_wall(views, (size, size), **kw)[0],
                loop=[seng.render_bricked(c, f, **kw)[0] for c, f, _off in views])
        call("/layout", "PUT", {"name": "2x2"})
        for name in ("wall", "loop"):
            seng.plan_wall = real_plan if name == "wall" else loop_only
            for _ in range(WALL_REQUESTS):
                if call("/image-jpeg", "POST", {})[:2] != b"\xff\xd8":
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
    n_wall_views = sum(2 * len(w["views"]) for w in walls.values())
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

    for layout, w in walls.items():
        parity = 0.0
        for (cam, _fr, (dx, dy)), img in zip(w["views"], w["loop"]):
            vw, vh = cam.viewport[2:]
            parity = max(parity, float((w["wall"][dy:dy + vh, dx:dx + vw] - img).abs().max()))
        if parity != 0.0:
            raise AssertionError(f"the {layout} wall's tiles are {parity} from the loop's frames")
        print(f"wall {layout} at {size}x{size} (sse {SERVE_SSE}): render_wall's tiles vs the "
              f"sequential loop's frames max|d| {parity} {card}")
    served_wall = canvases[:WALL_REQUESTS]
    served_loop = canvases[WALL_REQUESTS:]
    if len(canvases) != 2 * WALL_REQUESTS or any(
            not np.array_equal(a, b) for a, b in zip(served_wall, served_loop)):
        raise AssertionError("the service's wall canvas differs from its sequential canvas")
    print(f"service 2x2 requests (POST /image-jpeg, {size}x{size}): {WALL_REQUESTS} through the "
          f"wall, {WALL_REQUESTS} through the loop; served canvases bit-equal {card}")

    check_bf16(k1_rec.calls, k5_rec.calls)
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
    # main path's launches of each, the largest error on the windows.
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
            })
    print(f"phase 31: {time.perf_counter() - t_phase:.1f} s")
    return launches, errs, instance_entries


def phase_adam(dev, card, n=512, steps=5):
    """32. The trainers' update at full width: one Adam step of an n^3 leaf
    and a (256, 4) TF through ``step_optimizer`` (the kernel, one launch
    a leaf), for each epilogue (the exact trainer's density "none", the
    dense volume "clamp01", the store "pin" over a store whose first
    eighth is SENTINEL), against ``torch.optim.Adam``'s foreach step and
    the old epilogue as separate passes over ``steps`` steps (launches
    counted from 0, no fallback).  Returns the ``kernels`` line's entry
    (the launches of every counted main path, ``ADAM_RUNS``)."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops.adam import EPILOGUES
    from libre_tpu_torch.testing import ADAM_TOL_ULPS
    from libre_tpu_torch.train.update import separate_passes, step_optimizer

    def epilogues(leaves, epilogue):
        pin = [leaves[0]] if epilogue == "pin" else []
        return pin, [leaves[1]] + ([leaves[0]] if epilogue == "clamp01" else [])

    unit = 2.0**-23
    gen = torch.Generator(device=dev).manual_seed(21)
    gap = 0.0
    for epilogue in EPILOGUES:
        start = torch.rand((n, n, n), device=dev, generator=gen)
        if epilogue == "pin":
            start[:, :, : n // 8] = swb.SENTINEL
        tf0 = torch.rand((256, 4), device=dev, generator=gen)
        got = [start.clone().requires_grad_(), tf0.clone().requires_grad_()]
        want = [start.clone().requires_grad_(), tf0.clone().requires_grad_()]
        del start
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
        print(f"adam_update {epilogue}: {max(errs):.2f} ulps from torch over {steps} steps "
              f"(largest absolute gap so far {gap:.3e}) {card}")
        del got, want, opt_got, opt_want
        free_device_memory()
    return {
        "name": "adam_update",
        "route": "cuda",
        "source": "libre_tpu_torch/csrc/adam_update.cu",
        "replaces": None,
        "launches": sum(k for _, k in ADAM_RUNS),
        "max_abs_err": gap,
    }


def check_bf16(k1_calls, k5_calls):
    """Phase 31's recorded K1 and K5 launches, (f32, bf16) each: the bf16
    launches bit-equal to their plain versions (``compute_dtype=
    "bfloat16"``)."""
    import torch

    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_dense as swd

    (_, _k1_f32), (_, k1_bf16) = k1_calls
    (_, _k5_f32), (_, k5_bf16) = k5_calls
    ops, (out, t_out) = k1_operands(k1_bf16)
    want, t_want, _fetches = k1_plain(*ops)
    if not (torch.equal(out, want) and torch.equal(t_out, t_want)):
        raise AssertionError("K1's bf16 instance is not bit-equal to the plain bf16 sweep")
    (chans, a0, a1, wa, dl, act, vvec, corr, out5, _k, _nc, _nb, _v, _u,
     wb0, wb1, wc0, wc1, _sb, _sc, early_exit, bf16) = k5_bf16
    tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=vvec, corr=corr,
                             rgb_in=None, t_in=None)
    want5 = swd.pre_sweep_reference(chans, tables, wb=(wb0, wb1), wc=(wc0, wc1),
                                    early_exit=early_exit, compute_dtype="bfloat16")
    if not (bf16 == 1 and torch.equal(out5, want5)):
        raise AssertionError("K5's bf16 instance is not bit-equal to the plain bf16 sweep")
    print("bf16 resample on the main-path views: K1's and K5's bf16 launches bit-equal to "
          "their plain versions")


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
            want, t_want, fetches = k1_plain(store, tf, tables, clip, kw)
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
            del store, tables, got, want, fetches, lists

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
        rc = render_cli.main([
            "--volume", URI, "--width", "512", "--height", "512",
            "--output-dir", out_dir,
        ])
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"render_cli exited {rc}")
        png = read_image(os.path.join(out_dir, "frame_000000.png"))
    cli_launches = swb.post_sweep.launches
    if png.shape[:2] != (512, 512) or png.max() == 0:
        raise AssertionError(f"render_cli image {png.shape}, max {png.max()}")

    engine = RenderEngine(DataSource(URI), device=dev)
    frames, stats = [], None
    for camera, frustum in poses:
        img, stats = engine.render_bricked(camera, frustum, screen_space_error=1.0)
        frames.append(img)
    torch.cuda.synchronize()
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
        f"{launches} sweep launches for 1 CLI + {len(poses)} orbit frames {card}"
    )
    camera, frustum = poses[-1]
    tf = engine.transfer_function

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
    want, t_want, fetches = k1_plain(store, tf, tables, runner.clip, kw)
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
    del fetches, lists, got, want
    # The CLI frame's launch (sse 4), on the operands it was given.
    (_name, cli_args), = k1_cli.calls
    cli_ops, (cli_out, cli_t) = k1_operands(cli_args)
    want, t_want, _fetches = k1_plain(*cli_ops)
    torch.cuda.synchronize()
    if not (torch.equal(cli_out, want) and torch.equal(cli_t, t_want)):
        raise AssertionError("render_cli's sweep: K1 is not bit-equal to the plain sweep")
    print(f"K1 on render_cli's operands (store {tuple(cli_ops[0].shape)}): bit-equal to plain")
    del cli_ops, cli_args, cli_out, cli_t, want, t_want, _fetches, k1_cli

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

    swb.post_sweep.launches = 0
    swg.store_grid_backward.launches = 0
    with torch.no_grad():
        targets = render_views(problem, store, tf)
    # Phase 4's orbit at screen-space error 1 assembles all 4096 finest
    # bricks: the whole 512^3 store.
    if store.numel() != 512**3:
        raise AssertionError(f"the training store {tuple(store.shape)} is not 512^3")
    with adam_counted(f"store trainer fit ({'x'.join(map(str, store.shape))} store, pin)",
                      2 * TRAIN_STEPS):
        params, losses = fit(
            problem, targets, init, tf, device=dev,
            optimizer=lambda p: torch.optim.Adam(p, lr=5e-2), steps=TRAIN_STEPS,
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
    print(
        f"training: {TRAIN_VIEWS} views of {v_size}x{u_size} rays x "
        f"{runner.k_planes} planes over {tuple(store.shape)}, {n_uncovered} "
        f"uncovered voxels; sweep launches {train_fwd_launches}, backward "
        f"launches {train_bwd_launches}; checkpoint round trip equal {card}"
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
    ds_ref, dtf_ref = swg.store_grid_backward_reference(
        p_store, p_tf, tables, out, t_out, g, **bwd_kw
    )
    torch.cuda.synchronize()
    compare_grads(ds, ds_ref, "training-view backward: d_store", EARLY_EXIT_OFF)
    compare_grads(dtf, dtf_ref, "training-view backward: dtf", EARLY_EXIT_OFF)
    bwd_err = float((ds - ds_ref).abs().max())
    del ds_ref
    # K1 on the training view: bit-equal to plain.
    want, t_want, _fetches = k1_plain(p_store, p_tf, tables, clip0, fwd_kw)
    torch.cuda.synchronize()
    if not (torch.equal(out, want) and torch.equal(t_out, t_want)):
        raise AssertionError("training view 0: K1 is not bit-equal to the plain sweep")
    print("K1 on training view 0: bit-equal to plain")
    del want, t_want, _fetches
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
    del ds, ds_ref, out_t, t_out_t

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
    with tempfile.TemporaryDirectory() as out_dir:
        for renderer in ("pallas-exact", "xla"):
            rc = render_cli.main([
                "--volume", URI, "--width", "512", "--height", "512",
                "--renderer", renderer, "--output-dir", os.path.join(out_dir, renderer),
            ])
            torch.cuda.synchronize()
            cli_ok[renderer] = (rc, read_image(
                os.path.join(out_dir, renderer, "frame_000000.png")))
    exact_cli_launches = exact.march_exact.launches
    exact_frames, exact_stats = [], []
    for camera, frustum in poses:
        img, st, _ = engine.render(camera, frustum, screen_space_error=1.0, marcher="pallas")
        exact_frames.append(img)
        exact_stats.append(st)
    torch.cuda.synchronize()
    exact_launches = exact.march_exact.launches
    # ------------------------------------------ end of the exact main path

    for renderer, (rc, png) in cli_ok.items():
        if rc != 0 or png.shape[:2] != (512, 512) or png.max() == 0:
            raise AssertionError(f"render_cli --renderer {renderer}: rc {rc}, {png.shape}")
    if not np.array_equal(cli_ok["pallas-exact"][1], cli_ok["xla"][1]):
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
        f"{exact_launches} K3 launches for 2 CLI + {len(poses)} orbit frames {card}"
    )

    # The last pose's operands, as engine.render builds them.
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops.raycast import ray_pack

    camera, frustum = poses[-1]
    nodes = engine.select(frustum, 512, 1.0)
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
    k3_used = torch.zeros(len(order), dtype=torch.int32, device=dev)
    frame = exact.march_exact(*args, max_steps=max_steps, width=512, used=k3_used)
    torch.cuda.synchronize()
    if float((frame.reshape(512, 512, 4) - exact_frames[-1]).abs().max()) != 0.0:
        raise AssertionError("the rebuilt operands do not give the orbit's last frame")
    lists = raycast.tile_bricks_reference(pack, boxes, eye_np, 512)
    n_tiles = lists[..., 0].numel()
    print(
        f"  K3's brick lists on the orbit view: the {n_tiles} tiles of 16x8 rays list "
        f"{int(lists.sum()) / n_tiles:.1f} of the pass's {len(order)} bricks on average, at "
        f"most {int(lists.sum(dim=-1).max())}"
    )
    del lists
    # The same frame from only the bricks some ray samples: the others
    # must not change it.
    keep = k3_used.bool()
    sampled_args = (atlas, slots[keep].contiguous(), boxes[keep].contiguous(), tf, pack,
                    carry0, eye_np, exact_params)
    if not torch.equal(exact.march_exact(*sampled_args, max_steps=max_steps, width=512), frame):
        raise AssertionError("the bricks that take no sample changed the frame")
    print(f"  the same frame from the {int(keep.sum())} sampled bricks of {len(order)}: equal")

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
    want = exact.march_exact_reference(*sub_args, max_steps=max_steps, samples=counts[1][0],
                                       used=counts[1][1], width=SUBSET, tile_used=tile_used)
    torch.cuda.synchronize()
    what = f"main-path K3, {SUBSET}x{SUBSET} window"
    k3_err = compare(got, want, what, exact_tol)
    check_k3_counts((got, *counts[0]), (want, *counts[1]), what, exact_params.early_exit)
    if not bool((tile_used <= lists).all()):
        raise AssertionError(f"{what}: a tile samples a brick off its list")
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
    from libre_tpu_torch.testing import exact_grad_case

    def brick_args(volume, tf_, view):
        """K3's operands for one brick filling the view's box, less the carry."""
        slot = torch.zeros(1, dtype=torch.int32, device=volume.device)
        return (volume[None], slot, view.brick_boxes, tf_, view.ray_pack)

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

    # The autograd round trip at the exact_fwd_bwd shape (trilinear).
    c = exact_grad_case("bench", seed=1, device=dev)
    vol = c.volume.clone().requires_grad_()
    tf_leaf = c.tf.clone().requires_grad_()
    exact.render_exact_diff(vol, tf_leaf, c.view).mul(c.g).sum().backward()
    want = exact.march_exact_backward_reference(c.volume, c.tf, c.view, c.out, c.g)
    torch.cuda.synchronize()
    compare_k4((vol.grad, tf_leaf.grad), want, "render_exact_diff backward on the card")
    del c, vol, tf_leaf, want

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
    torch.cuda.synchronize()
    exact.march_exact.launches = 0
    exact.march_exact_backward.launches = 0
    with adam_counted(f"exact trainer ({n}^3 density)", 2 * len(EXACT_TRAIN_ORDER)):
        ex_losses = [float(ex_steps[i](state, ex_targets[i])) for i in EXACT_TRAIN_ORDER]
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
    v0 = ex_views[0]
    print(
        f"exact training: {n}^3 f32 volume, {len(ex_views)} views of 512x512 rays, 512 "
        f"samples per ray, trilinear, early exit off; K3 launches {ex_fwd_launches}, K4 "
        f"launches {ex_bwd_launches}; mean |density - truth| "
        f"{float((p_vol - gt).abs().mean()):.4f} {card}"
    )

    # View 0 with the trained state, kernel vs plain: the forward's out and
    # a seeded N(0, 1) cotangent in place of the loss's.
    fwd_args = (*brick_args(p_vol, p_tf, v0), torch.zeros((v0.n_rays, 4), device=dev))
    out0 = exact.march_exact(*fwd_args, v0.eye, v0.params, max_steps=v0.max_steps,
                             width=v0.width)
    gen = torch.Generator(device="cpu").manual_seed(0)
    g0 = torch.randn(out0.shape, generator=gen).to(dev)
    args = (p_vol, p_tf, v0, out0, g0)
    got = exact.march_exact_backward(*args)
    want = exact.march_exact_backward_reference(*args)
    torch.cuda.synchronize()
    _, k4_err = compare_k4(got, want, "K4 on training view 0")
    del got, want
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
    del gt64, gt, ex_targets, gt_args

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
    want_w = exact.march_exact_reference(*sub_fwd, w0.eye, w0.params, max_steps=w0.max_steps,
                                         samples=counts[1][0], used=counts[1][1])
    torch.cuda.synchronize()
    what = f"K3 on a {SUBSET}x{SUBSET} window of training view 0"
    k3_train_err = compare(out_w, want_w, what, exact_tol)
    check_k3_counts((out_w, *counts[0]), (want_w, *counts[1]), what, train_params.early_exit)
    g_w = g0.reshape(512, 512, 4)[lo:lo + SUBSET, lo:lo + SUBSET].reshape(-1, 4).contiguous()
    sub_args = (p_vol, p_tf, w0, out_w, g_w)
    got = exact.march_exact_backward(*sub_args)
    want = exact.march_exact_backward_reference(*sub_args)
    torch.cuda.synchronize()
    compare_k4(got, want, f"K4 on a {SUBSET}x{SUBSET} window of training view 0")
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
    # main path: count their calls.
    plain_calls = []
    real_fns = (swd.pre_sweep_reference, sw.render_slope_grid)

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    swd.pre_sweep_reference = counted(real_fns[0])
    sw.render_slope_grid = counted(real_fns[1])
    dense_engine = RenderEngine(DataSource(URI), device=dev)
    try:
        swd.pre_sweep.launches = 0
        with tempfile.TemporaryDirectory() as out_dir:
            rc = render_cli.main([
                "--volume", URI, "--width", "512", "--height", "512",
                "--renderer", "shearwarp", "--output-dir", out_dir,
            ])
            torch.cuda.synchronize()
            dense_png = read_image(os.path.join(out_dir, "frame_000000.png"))
        dense_cli_launches = swd.pre_sweep.launches
        dense_frames = [dense_engine.render_shearwarp(camera) for camera, _frustum in poses]
        torch.cuda.synchronize()
        dense_launches = swd.pre_sweep.launches
    finally:
        swd.pre_sweep_reference, sw.render_slope_grid = real_fns
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
        f"{dense_launches} K5 launches for 1 CLI + {len(poses)} orbit frames, no plain call "
        f"{card}"
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
    pa = swd.slope_grid_plan_args(sw.make_view_plan(camera, dense_swp.slope_margin),
                                  -half, half, dense_params, dense_swp)
    frame = swd.render_frame(chans, chans.shape[1], chans.shape[2], camera, pa, content)
    dense_last = dict(chans=chans, content=content, pa=pa, camera=camera)  # phase 31's bf16 K5
    torch.cuda.synchronize()
    if not torch.equal(frame, dense_frames[-1]):
        raise AssertionError("the rebuilt operands do not give the dense orbit's last frame")
    _fv, tables = swd.sweep_operands(chans, pa, camera, content)
    kw = pa.sweep_kwargs()
    got = swd.pre_sweep(chans, tables, **kw)
    k5_lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
    k5_fetches = torch.zeros_like(k5_lists)
    want = swd.pre_sweep_reference(chans, tables, fetches=k5_fetches, **kw)
    torch.cuda.synchronize()
    k5_err = compare(got, want, "main-path K5")
    if not torch.equal(got, want):
        raise AssertionError("main-path K5 is not bit-equal to the plain sweep")
    if not bool((k5_fetches <= k5_lists).all()):
        raise AssertionError("main-path K5: a tile composites at a plane off its list")
    n_tiles = k5_lists[..., 0].numel()
    print(
        f"  bit-equal; the {n_tiles} tiles of {swb.SWEEP_TILE[0]}x{swb.SWEEP_TILE[1]} rays "
        f"list {int(k5_lists.sum()) / n_tiles:.1f} planes each on average (of "
        f"{int(tables.act.sum())} active), at most {int(k5_lists.sum(dim=-1).max())}; they "
        f"composite at {int(k5_fetches.sum()) / n_tiles:.1f}"
    )
    del k5_lists, k5_fetches, got, want, tables, dense_frames, frame

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
    ooc_launches, ooc_err = phase_out_of_core(dev, card)
    phase_done(18, quiet=True)
    # ----------------------- 19. the gather probes P1-P17 (their own timers)
    probe_entries = phase_probes(dev, card)
    phase_done(19, quiet=True)
    # ------------------------------------- 20. the render service (its own timers)
    serve_k1, serve_k3 = phase_serve(dev, card)
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
    mesh_k1 = phase_sharded_orbit(dev, card, engine, poses)
    phase_done(25)
    train_k1, train_k2, mesh_k2_err = phase_sharded_training(
        dev, card, problem, store, tf, targets)
    phase_done(26)
    mesh_k3 = phase_sharded_exact(dev, card, exact_tol)
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
        dev, card, exact_tol, ex_views[0], engine, poses[-1], dense_last)
    phase_done(31, quiet=True)
    # ------------------------------- 32. the trainers' update (the Adam kernel)
    adam_entry = phase_adam(dev, card)
    print("the Adam kernel's launches on the main paths, each counted from 0 with no fallback "
          "(a leaf a step): " + "; ".join(f"{what} {k}" for what, k in ADAM_RUNS))
    phase_done(32)
    print("phase seconds (utils.profiling.StageTimers):")
    for line in timers.report().splitlines():
        print(f"  {line}")

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "libre_tpu")]
    if loaded:
        raise AssertionError(f"imported {loaded[:5]}")

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
        },
        {
            "name": "store_grid_bwd",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/store_grid_bwd.cu",
            "replaces": "libre_tpu/ops/shearwarp_grad.py:440",
            "launches": render_bwd_launches + train_bwd_launches + scripts["store_grid_bwd"]
            + train_k2,
            "max_abs_err": max(bwd_err, script_errs["store_grid_bwd"], mesh_k2_err),
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
        },
        {
            "name": "pre_sweep",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/pre_sweep.cu",
            "replaces": "libre_tpu/ops/shearwarp_pallas.py:206",
            "launches": dense_launches + p31_launches["pre_sweep"],
            "max_abs_err": max(k5_err, p31_errs["pre_sweep"]),
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
