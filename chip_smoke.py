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
   a small volume.

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
    from libre_tpu_torch.testing import sweep_case

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
    # ------------------------------------------------- end of the main path

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

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(json.dumps({"kernels": [{
        "name": "post_sweep",
        "route": "cuda",
        "source": "libre_tpu_torch/csrc/post_sweep.cu",
        "replaces": "libre_tpu/ops/shearwarp_bricked.py:78",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
