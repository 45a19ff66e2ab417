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
   per view; a checkpoint round trip; step, kernel and plain times.

Prints one JSON line describing the kernels, then, as the last line,
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


def compare(got, want, what):
    """(max, mean) |got − want|; raises past the kernel tolerances."""
    import torch

    from libre_tpu_torch.testing import KERNEL_TOL_MAX, KERNEL_TOL_MEAN

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    mx, mean = float(err.max()), float(err.mean())
    print(f"{what}: max|d| {mx:.3e} mean|d| {mean:.3e}")
    if mx > KERNEL_TOL_MAX or mean > KERNEL_TOL_MEAN:
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
    from libre_tpu.data.datasource import DataSource, load_plugins
    from libre_tpu.utils.image import read_image
    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.render.engine import RenderEngine

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
    want, t_want = swb.post_sweep_reference(
        store, tf, tables, runner.clip, samples=samples, **kw
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

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

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
