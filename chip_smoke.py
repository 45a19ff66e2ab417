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
   × 128 planes and at 512² rays × 512 planes over a 512³ store, with the
   early exit off (1.1, the training setting) and on (0.999, saturating
   TF), the TF gradient on and off;
7. the training path: ``fit`` recovers the orbit's 512³ store and the TF
   from 4 orbit views (512² slope grids, K = 512) in 5 Adam steps from a
   flat init; every step launches the sweep and the backward kernel once
   per view; a checkpoint round trip; step, kernel and plain times;
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
   9-slot atlas (passes of 8 bricks) with 2 jittered samples per pixel.

Prints one JSON line describing the kernels (with each kernel's bound:
the larger of its bytes over the HBM rate and its f32 operations over
their peak, from this run's work), then, as the last line,
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when
no CUDA device is present.
"""

from __future__ import annotations

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
K2_OPS_PER_SAMPLE = 175
K3_OPS_PER_SAMPLE = {"nearest": 69, "trilinear": 122}


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


def compare_grads(got, want, what, early_exit):
    """Normalised (max, mean) |got − want| / max |want|; raises past the
    backward kernel's tolerances."""
    import torch

    from libre_tpu_torch.testing import (
        GRAD_TOL_MAX,
        GRAD_TOL_MAX_EARLY_EXIT,
        GRAD_TOL_MEAN_EARLY_EXIT,
    )

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    scale = float(want.abs().max())
    if scale == 0.0:
        raise AssertionError(f"{what}: the plain gradient is zero")
    err = (got - want).abs() / scale
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d|/max|plain| {mx:.3e} mean {mean:.3e} (max|plain| {scale:.3e})")
    if early_exit < 1.0:
        bad = mx > GRAD_TOL_MAX_EARLY_EXIT or mean > GRAD_TOL_MEAN_EARLY_EXIT
    else:
        bad = mx > GRAD_TOL_MAX
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with plain ({mx}, {mean})")
    return mx


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
    from libre_tpu_torch.testing import store_grad_case, sweep_case

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
    want, t_want = swb.post_sweep_reference(
        store, tf, tables, runner.clip, samples=samples, planes=planes, **kw
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
    # K1's bound: the store slices of the planes some ray fetches, read
    # once, plus the per-ray operands and outputs; the fetched samples'
    # operations.
    slices = torch.unique(torch.cat([tables.a0[planes], tables.a1[planes]]))
    _na, s_nc, s_nb = store.shape
    k1_bound = bound(
        bytes_=slices.numel() * s_nc * s_nb * 4 + n_rays * 11 * 4 + TF_BYTES
        + runner.k_planes * 5 * 4,
        ops=fetched * K1_OPS_PER_SAMPLE,
    )
    print(
        f"  K1 bound: {slices.numel()} store slices read by {int(planes.sum())} "
        f"planes; {k1_bound[0]:.4f} ms, {k1_bound[1]}-bound; kernel at "
        f"{k1_bound[0] / ms:.4f} of it {card}"
    )

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
    for shape in ((96, 80, 128, 64, 48, 56), (512, 512, 512, 512, 512, 512)):
        for early_exit in (1.1, 0.999):
            store_s, tf_s, tables_s, out_s, t_s, g_s, kw_s = store_grad_case(
                shape, seed=0, device=dev, early_exit=early_exit
            )
            ds_ref, dtf_ref = swg.store_grid_backward_reference(
                store_s, tf_s, tables_s, out_s, t_s, g_s, diff_tf=True, **kw_s
            )
            for diff_tf in (True, False):
                ds, dtf = swg.store_grid_backward(
                    store_s, tf_s, tables_s, out_s, t_s, g_s, diff_tf=diff_tf, **kw_s
                )
                torch.cuda.synchronize()
                what = f"seeded backward {shape} early_exit={early_exit} diff_tf={diff_tf}"
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
    bwd_ms = cuda_ms(
        lambda: swg.store_grid_backward(p_store, p_tf, tables, out, t_out, g, **bwd_kw),
        reps=5, warmup=1,
    )
    bwd_no_tf_ms = cuda_ms(
        lambda: swg.store_grid_backward(
            p_store, p_tf, tables, out, t_out, g, **dict(bwd_kw, diff_tf=False)
        ),
        reps=5, warmup=1,
    )
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
        f"training view 0: sweep {fwd_ms:.3f} ms, backward kernel {bwd_ms:.3f} ms "
        f"(incl. zeroing the {na * nc * nb * 4} B d_store; {bwd_no_tf_ms:.3f} ms "
        f"without the TF gradient), plain backward "
        f"{bwd_plain_ms:.3f} ms (1 call); backward "
        f"{in_box[0] / (bwd_ms * 1e-3) / 1e9:.3f} G samples/s {card}"
    )
    print(
        f"samples inside the box per view (all fetched, early exit off), of "
        f"{n_grid}: {in_box} ({', '.join(f'{x / n_grid:.4f}' for x in in_box)})"
    )
    # K2's bound: the store read and d_store written once, out, t_out, g and
    # the per-ray tables read, the TF and dtf; every in-box sample's
    # operations (early exit off).
    k2_bound = bound(
        bytes_=2 * na * nc * nb * 4 + v_size * u_size * 15 * 4 + 2 * TF_BYTES
        + runner.k_planes * 5 * 4,
        ops=in_box[0] * K2_OPS_PER_SAMPLE,
    )
    print(
        f"  K2 bound on view 0: {k2_bound[0]:.4f} ms, {k2_bound[1]}-bound; kernel "
        f"at {k2_bound[0] / bwd_ms:.4f} of it {card}"
    )

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

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "libre_tpu")]
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
            "launches": exact_launches,
            "max_abs_err": k3_err,
            "ms": k3_ms,
            "plain_ms": k3_plain_ms,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
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
