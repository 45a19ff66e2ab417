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
   (512² rays × 512 planes over a 512³ store);
4. the main path: ``render_cli.main`` on a 512³ uint8 ``mem://`` volume
   at 512×512 (default LOD selection: a mixed-LOD set), then an 8-pose
   orbit through ``RenderEngine.render_bricked`` at screen-space error 1
   (all 4096 finest bricks, a 512³ store) within one major axis, so
   frames 2-8 reuse the cached store; the sweep kernel must launch once
   per frame;
5. kernel vs plain on the main path's own operands (timed, with the
   work behind the time: active planes, rays that fetch, early exits,
   samples fetched), and the port on the card vs the port on the CPU on
   a small volume;
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
   the bound);
8. the exact marcher K3 vs plain PyTorch on seeded operands: the
   ``bench_exact`` shape (one 64³ f32 brick, 256² rays, 512 samples per
   ray) and a scattered 64-brick uint8 atlas with clip planes, a
   saturating transfer function and a carry in, nearest and trilinear;
9. the exact main path: ``render_cli --renderer pallas-exact`` and then
   ``--renderer xla`` on the 512³ volume at 512×512 (the same frame), and
   an 8-pose orbit through ``RenderEngine.render(marcher="pallas")`` at
   screen-space error 1 (all 4096 finest bricks, 512 samples per ray) on
   the bricked orbit's engine; K3 must launch once per pass per sample;
   frame, select and kernel times and the work behind them (samples
   composited, bricks sampled, rays ended by the early exit);
10. K3 vs plain on a 64×64 window of the orbit view's rays (the plain
   version over all 512² rays and 4096 bricks would take minutes);
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
   each timed with the TF gradient on and off; K3 and K4 vs plain on a
   64×64 window of it;
14. the exact trainer on the card vs on the CPU: 2 SGD steps on a 32³
   volume seen by 24×20 rays;
15. the dense pre-classified sweep K5 vs plain PyTorch on seeded
   operands: the JAX package's dense test scene (20×24×28, a (24, 40)
   grid, 24 planes) from all four eyes, with empty slices and a
   saturating TF, and a 512³ RGBA stack under 512² rays × 512 planes;
16. the dense main path: ``render_cli --renderer shearwarp`` on the 512³
   volume at 512×512 (level 4, a 2 GiB classified stack, K = 512), then
   the 8-pose orbit through ``RenderEngine.render_shearwarp``, frames 2-8
   on the cached stack; K5 must launch once per frame and no plain
   version may run; first-frame split (level assembly, classify), steady
   frames, K5 and plain times on the last pose and the work behind them;
17. the dense path on the card (K5) vs on the CPU (the plain pipeline) on
   a small volume, and the autograd Function's forward and gradients on
   the card vs on the CPU.

Prints one JSON line describing the kernels (with each kernel's bound:
the larger of its bytes over the HBM rate and its f32 operations over
their peak, from this run's work), then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

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
# The exact trainer's views: benchmarks/demo_inverse_render.py:34-37.
EXACT_EYES = ([0.1, 0.05, 1.4], [-0.15, 0.1, 1.3], [0.02, -0.12, 1.5], [-0.05, -0.02, 1.2])
EXACT_TRAIN_N = 512
EXACT_TRAIN_ORDER = (0, 1, 2, 3, 0)


def bound(bytes_, ops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def profiled(what, fn, tags, card, unprofiled_ms):
    """Run ``fn`` (which must end by synchronising) once under
    torch.profiler and print its host-clock time, its device time in
    kernels and in copies (memcpy, memset) with their counts, the device's
    idle share of ``unprofiled_ms`` (the same work's host-clock time
    without the profiler, whose own cost inflates its clock) and of the
    profiled clock, and the kernels' time by the first of ``tags`` in each
    kernel's name ("other" for none).  Annotated ranges, which span
    kernels, are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups, n_kernels, copy_ms, n_copies = {}, 0, 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3
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


def compare(got, want, what, tol=None):
    """(max, mean) |got − want|; raises past ``tol`` = (max, mean), by
    default the sweep kernel's tolerances."""
    import torch

    from libre_tpu_torch.testing import KERNEL_TOL_MAX, KERNEL_TOL_MEAN

    tol_max, tol_mean = tol or (KERNEL_TOL_MAX, KERNEL_TOL_MEAN)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d| {mx:.3e} mean|d| {mean:.3e}")
    if mx > tol_max or mean > tol_mean:
        raise AssertionError(
            f"{what}: kernel disagrees with plain (max {mx}, mean {mean})"
        )
    return mx


def compare_grads(got, want, what, early_exit, tol_max=None, expect_zero=False):
    """Normalised (max, mean) |got − want| / max |want|; raises past the
    backward kernels' tolerances (``tol_max``: the max with the early
    exit off, by default K2's).  With ``expect_zero`` (K4's density
    gradient on the "top" field: every sample past the density gate) both
    must be exactly zero; otherwise a zero plain gradient raises."""
    import torch

    from libre_tpu_torch.testing import (
        GRAD_TOL_MAX,
        GRAD_TOL_MAX_EARLY_EXIT,
        GRAD_TOL_MEAN_EARLY_EXIT,
    )

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    scale = float(want.abs().max())
    if expect_zero:
        mx = float(got.abs().max())
        print(f"{what}: expected zero, max|kernel| {mx:.3e}, max|plain| {scale:.3e}")
        if mx != 0.0 or scale != 0.0:
            raise AssertionError(f"{what}: gradient not zero (kernel {mx}, plain {scale})")
        return 0.0
    if scale == 0.0:
        raise AssertionError(f"{what}: the plain gradient is zero")
    err = (got - want).abs() / scale
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d|/max|plain| {mx:.3e} mean {mean:.3e} (max|plain| {scale:.3e})")
    if early_exit < 1.0:
        bad = mx > GRAD_TOL_MAX_EARLY_EXIT or mean > GRAD_TOL_MEAN_EARLY_EXIT
    else:
        bad = mx > (GRAD_TOL_MAX if tol_max is None else tol_max)
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with plain ({mx}, {mean})")
    return mx


def rate(what, ms, samples, bound_ms, card):
    """Print a kernel time with its samples per second and its share of
    the bound."""
    print(
        f"  {what}: {ms:.4f} ms, {samples / (ms * 1e-3) / 1e9:.3f} G samples/s; bound "
        f"{bound_ms:.4f} ms, kernel at {bound_ms / ms:.4f} of it {card}"
    )


def orbit_cameras(n=8, width=512, height=512):
    from libre_tpu_torch.apps.render_cli import build_camera

    poses = []
    for az in np.linspace(-10.0, 10.0, n):
        a = np.deg2rad(az)
        eye = (1.5 * np.sin(a), 0.15, 1.5 * np.cos(a))
        poses.append(build_camera(width, height, eye, (0.0, 0.0, 0.0)))
    return poses


def main() -> int:
    import torch

    # ---------------------------------------------------------- 1. the card
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
    from libre_tpu_torch.testing import FIELDS, store_grad_case, sweep_case

    # ------------------------------------------------------------- 2. build
    for name, secs in _kernels.build_all().items():
        print(f"build {name}: {secs:.2f} s ({_kernels.library_path(name).name})")

    # ------------------------------------------- 3. kernel vs plain, seeded
    for shape in ((96, 80, 128, 64, 48, 56), (512, 512, 512, 512, 512, 512)):
        store, tf, tables, clip, kw = sweep_case(shape, seed=0, device=dev)
        got, t_got = swb.post_sweep(store, tf, tables, clip, **kw)
        want, t_want = swb.post_sweep_reference(store, tf, tables, clip, **kw)
        torch.cuda.synchronize()
        compare(got, want, f"seeded sweep V,U,K,Na,Nc,Nb={shape}")
        compare(t_got, t_want, f"seeded transmittance {shape}")
        saturated = float((got[..., 3] > 0.999).float().mean())
        print(f"  early exit reached by {saturated:.3f} of the rays")
        if saturated == 0.0:
            raise AssertionError("the seeded case never fired the early exit")
        del store, tables, got, want

    # --------------------------------------------------------- 4. main path
    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.utils.image import read_image

    load_plugins()
    poses = orbit_cameras()
    swb.post_sweep.launches = 0
    swg.store_grid_backward.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
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

    # -------------------------- 5. kernel vs plain at the main path's shape
    sw_plan = sw.make_view_plan(camera)
    fv = torch.from_numpy(runner.view_vector(camera, sw_plan)).to(dev)
    tables = swb.sweep_tables(
        fv, na=runner.na, k_planes=runner.k_planes, v_size=runner.v_size,
        u_size=runner.u_size, content=runner.content,
    )
    kw = dict(n_clip=runner.n_clip, wb=runner.wb, wc=runner.wc,
              early_exit=runner.early_exit)
    got, _ = swb.post_sweep(store, tf, tables, runner.clip, **kw)
    samples = torch.zeros((runner.v_size, runner.u_size), dtype=torch.int64, device=dev)
    planes = torch.zeros(runner.k_planes, dtype=torch.bool, device=dev)
    touched = torch.zeros(store.shape, dtype=torch.bool, device=dev)
    want, t_want = swb.post_sweep_reference(
        store, tf, tables, runner.clip, samples=samples, planes=planes, touched=touched,
        **kw
    )
    torch.cuda.synchronize()
    max_err = compare(got, want, "main-path sweep")
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
    # K1's bound: the store voxels under the taps of the fetched samples,
    # each read once, plus the per-ray operands and outputs; the fetched
    # samples' operations.
    slices = torch.unique(torch.cat([tables.a0[planes], tables.a1[planes]]))
    _na, s_nc, s_nb = store.shape
    n_touched = int(touched.sum())
    k1_bound = bound(
        bytes_=n_touched * 4 + n_rays * 11 * 4 + TF_BYTES + runner.k_planes * 5 * 4,
        ops=fetched * K1_OPS_PER_SAMPLE,
    )
    print(
        f"  K1 bound: {n_touched} store voxels read ({n_touched / (slices.numel() * s_nc * s_nb):.4f} "
        f"of the {slices.numel()} slices of the {int(planes.sum())} planes fetched); "
        f"{k1_bound[0]:.4f} ms, {k1_bound[1]}-bound; kernel at {k1_bound[0] / ms:.4f} of it {card}"
    )
    del touched

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
    t0 = time.perf_counter()
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

    # ---------------------------------------- 8. K3 vs plain, seeded cases
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.testing import EXACT_TOL_MAX, EXACT_TOL_MEAN, exact_case

    exact_tol = (EXACT_TOL_MAX, EXACT_TOL_MEAN)
    for case, dtype in (("single", torch.float32), ("bricks", torch.uint8)):
        for filter_mode in ("nearest", "trilinear"):
            c = exact_case(case, seed=0, device=dev, filter_mode=filter_mode, dtype=dtype)
            args = (c.atlas, c.slots, c.boxes, c.tf, c.rays, c.carry, c.eye, c.params)
            got = exact.march_exact(*args, max_steps=c.max_steps, width=c.width)
            want = exact.march_exact_reference(*args, max_steps=c.max_steps)
            torch.cuda.synchronize()
            what = (f"seeded K3 {case} {tuple(c.atlas.shape)} {c.atlas.dtype} "
                    f"{filter_mode}, {c.carry.shape[0]} rays")
            compare(got, want, what, exact_tol)
            saturated = float((got[:, 3] > c.params.early_exit).float().mean())
            print(f"  early exit reached by {saturated:.3f} of the rays")
            if saturated == 0.0:
                raise AssertionError(f"{what}: the early exit never fired")
            del c, args, got, want

    # --------------------------------------- 9. the exact main path
    exact.march_exact.launches = 0
    cli_ok = {}
    with tempfile.TemporaryDirectory() as out_dir:
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
    # K3's bound: the bricks some ray samples (their atlas slots) read
    # once, the boxes, slots, ray pack, carry in and out and the TF; the
    # composited samples' operations.
    k3_bound = bound(
        bytes_=used_bricks * engine.atlas.slot_bytes + len(order) * (16 + 1) * 4
        + n_rays * (8 + 4 + 4) * 4 + TF_BYTES,
        ops=composited * K3_OPS_PER_SAMPLE[exact_params.filter_mode],
    )
    # The same frame from only the bricks some ray samples: what the
    # per-ray slab tests of the other bricks cost.
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
        f"{k3_sampled_ms:.4f} ms (the slab tests of the other {len(order) - used_bricks} "
        f"bricks cost the difference) {card}"
    )

    # ------------------ 10. K3 vs plain on a window of the main path's rays
    lo = (512 - SUBSET) // 2
    sub = pack.reshape(8, 512, 512)[:, lo:lo + SUBSET, lo:lo + SUBSET]
    sub = sub.reshape(8, -1).contiguous()
    sub_args = (atlas, slots, boxes, tf, sub, torch.zeros((SUBSET * SUBSET, 4), device=dev),
                eye_np, exact_params)
    got = exact.march_exact(*sub_args, max_steps=max_steps, width=SUBSET)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = exact.march_exact_reference(*sub_args, max_steps=max_steps)
    torch.cuda.synchronize()
    k3_plain_ms = (time.perf_counter() - t0) * 1e3
    k3_err = compare(got, want, f"main-path K3, {SUBSET}x{SUBSET} window", exact_tol)
    k3_sub_ms = cuda_ms(lambda: exact.march_exact(*sub_args, max_steps=max_steps, width=SUBSET),
                        reps=20)
    print(
        f"  on the {SUBSET}x{SUBSET} window: kernel {k3_sub_ms:.4f} ms, plain "
        f"{k3_plain_ms:.3f} ms (1 call) {card}"
    )
    for e in entries:
        e.unpin()
    del args, sampled_args, sub_args, pack, frame

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

    # ---------------------------------------- 12. K4 vs plain, seeded cases
    from libre_tpu_torch.testing import EXACT_GRAD_TOL_MAX, exact_grad_case

    def brick_args(volume, tf_, view):
        """K3's operands for one brick filling the view's box, less the carry."""
        slot = torch.zeros(1, dtype=torch.int32, device=volume.device)
        return (volume[None], slot, view.brick_boxes, tf_, view.ray_pack)

    def k4_work_bound(volume, view, samples, filter_mode, diff_tf):
        """K4's bound: the volume read and d_volume written once, the ray
        pack, out and g read, the TF and (with the TF gradient) d_tf;
        every sample's operations."""
        ops = K4_OPS_PER_SAMPLE[filter_mode] - (0 if diff_tf else K4_TF_OPS_PER_SAMPLE)
        return bound(
            bytes_=2 * volume.numel() * 4 + view.n_rays * 16 * 4 + (1 + diff_tf) * TF_BYTES,
            ops=samples * ops,
        )

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
    out_w = exact.march_exact(*sub_fwd, w0.eye, w0.params, max_steps=w0.max_steps,
                              width=w0.width)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_w = exact.march_exact_reference(*sub_fwd, w0.eye, w0.params, max_steps=w0.max_steps)
    torch.cuda.synchronize()
    k3_plain_window_ms = (time.perf_counter() - t1) * 1e3
    k3_train_err = compare(out_w, want_w, f"K3 on a {SUBSET}x{SUBSET} window of training "
                                          f"view 0", exact_tol)
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

    # ----------------------------------------- 15. K5 vs plain, seeded cases
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.testing import DENSE_EYES, DENSE_GRAD_TOL, dense_case, dense_grad_case

    for case, eye in [("scene", e) for e in DENSE_EYES] + [("slice", "z-")]:
        c = dense_case(case, seed=0, device=dev, eye=eye)
        kw = c.plan_args.sweep_kwargs()
        got = swd.pre_sweep(c.chans, c.tables, **kw)
        want = swd.pre_sweep_reference(c.chans, c.tables, **kw)
        torch.cuda.synchronize()
        k_planes = c.tables.a0.shape[0]
        v_size, u_size = c.tables.corr.shape
        what = (f"seeded K5 {case} {eye if case == 'scene' else ''} {tuple(c.chans.shape)}, "
                f"{v_size}x{u_size} rays x {k_planes} planes")
        compare(got, want, what)
        n_act = int(c.tables.act.sum())
        saturated = float((got[..., 3] > kw["early_exit"]).float().mean())
        print(f"  active planes {n_act}/{k_planes}, early exit reached by {saturated:.3f} "
              f"of the rays")
        if saturated == 0.0 or n_act == k_planes:
            raise AssertionError(f"{what}: no early exit or no empty plane")
        del c, got, want

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
    want = swd.pre_sweep_reference(chans, tables, samples=k5_samples, planes=k5_planes,
                                   touched=k5_touched, **kw)
    torch.cuda.synchronize()
    k5_err = compare(got, want, "main-path K5")
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

    loaded =[m for m in sys.modules if m.split(".")[0] in ("jax", "libre_tpu")]
    if loaded:
        raise AssertionError(f"imported {loaded[:5]}")

    print(json.dumps({"kernels": [
        {
            "name": "post_sweep",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/post_sweep.cu",
            "replaces": "libre_tpu/ops/shearwarp_bricked.py:78",
            "launches": launches + train_fwd_launches,
            "max_abs_err": max_err,
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
            "launches": render_bwd_launches + train_bwd_launches,
            "max_abs_err": bwd_err,
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
        },
        {
            "name": "exact_march",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/exact_march.cu",
            "replaces": "libre_tpu/ops/exact_pallas.py:481",
            "launches": exact_launches + ex_fwd_launches,
            "max_abs_err": max(k3_err, k3_train_err),
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
        {
            "name": "exact_march_bwd",
            "route": "cuda",
            "source": "libre_tpu_torch/csrc/exact_march_bwd.cu",
            "replaces": "libre_tpu/ops/exact_pallas.py:1405",
            "launches": ex_bwd_launches,
            "max_abs_err": k4_err,
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
            "launches": dense_launches,
            "max_abs_err": k5_err,
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound[0],
            "bound_by": k5_bound[1],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
