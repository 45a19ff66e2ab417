"""Config 3 at scale (the JAX package's ``benchmarks/demo_out_of_core.py``):
convert a large volume to ``lod://``, render a camera path out of core
(working set over the device budget, atlas evictions live) and record
throughput and paging statistics::

    python -m libre_tpu_torch.benchmarks.demo_out_of_core [--vox 1024] \\
        [--img 256] [--frames 8] [--out chiprun_out/ooc_run.json]

Two runs over the same orbit and rendering sets, each through
``RenderEngine.render_bricked`` (K1, ``csrc/post_sweep.cu``):

* in core: a device budget large enough for the assembled store;
* out of core: a budget squeezed so that every frame renders in A-slab
  passes with per-pass atlas paging (GLRaycastPipeline.cpp:148-186);
  brick evictions must occur.

Two warm laps, then a measured lap pipelined one frame deep: frame i+1's
host work runs while frame i's kernels execute, and frame i is waited
for (a CUDA event) before frame i+2 is dispatched.  Every out-of-core
frame of the measured lap must equal its in-core frame bit for bit, and
the last in-core frame must equal the same frame with K1's plain version
(``_common.plain``); a difference raises.  The JSON record has the
reference's keys.  Its default path lies under ``chiprun_out/``,
which is not committed; the LOD store is built once into the temporary
directory (``--store``).

Left out: ``--ooc-atlas-fraction``.  The port's atlas always takes
``engine.ATLAS_FRACTION`` of the budget; the squeezed budget alone pages
the atlas.  ``--device cpu`` renders with the plain sweep.  The last two
lines give the check's largest error and the render kernels' launch
counts (the check's launches not counted).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from ._common import check, log, plain, print_launches

# The record's keys, the reference's (benchmarks/demo_out_of_core.py:174-220):
# at the top, and in each of "incore" and "out_of_core".
RECORD_KEYS = ("volume_voxels", "store_bytes", "img", "planes", "frames", "sse", "min_lod",
               "device", "incore", "out_of_core", "ooc_vs_incore", "note")
RUN_KEYS = ("budget_mb", "ms_per_frame", "mrays_per_s", "passes_per_frame",
            "bricks_per_frame", "atlas_evictions", "atlas_hits", "atlas_misses",
            "data_cache_evictions")


def make_volume(n):
    """Smooth multi-blob uint8 density at n³, built slab-wise to bound RAM."""
    rng = np.random.default_rng(7)
    blobs = [
        (rng.uniform(-0.6, 0.6, 3), rng.uniform(0.1, 0.35), rng.uniform(80, 255))
        for _ in range(8)
    ]
    vol = np.zeros((n, n, n), np.uint8)
    g = np.linspace(-1, 1, n, dtype=np.float32)
    y, x = np.meshgrid(g, g, indexing="ij")
    for iz in range(n):
        z = g[iz]
        acc = np.zeros((n, n), np.float32)
        for c, s, a in blobs:
            acc += a * np.exp(
                -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s)
            )
        vol[iz] = np.clip(acc, 0, 255).astype(np.uint8)
    return vol


def orbit_views(img, n_frames, dist=1.45):
    from ..core.frustum import Frustum, look_at, perspective
    from ..ops.reference import Camera

    proj = perspective(50.0, 1.0, 0.1, 15.0)
    out = []
    for i in range(n_frames):
        az = np.deg2rad(8.0 * i - 12.0)
        eye = [dist * np.sin(az) + 0.05, 0.1, dist * np.cos(az)]
        mv = look_at(eye, [0, 0, 0], [0, 1, 0])
        cam = Camera(
            inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
            inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
            viewport=(0, 0, img, img),
            near=0.1,
        )
        out.append((cam, Frustum(mv.astype(np.float32), proj)))
    return out


def _done_marker(device):
    """A callable that marks the work queued so far, and one that waits
    for it: a CUDA event on the card, nothing on the CPU."""
    if torch.device(device).type != "cuda":
        return lambda: None
    def mark():
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return mark


def run_path(engine, views, n_planes, sse=4.0, min_lod=0):
    mark = _done_marker(engine.device)
    for _ in range(2):  # warm laps: first-touch IO and uploads for every camera
        for cam, fr in views:
            engine.render_bricked(cam, fr, n_planes=n_planes, screen_space_error=sse,
                                  min_lod=min_lod)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    stats_all, frames = [], []
    prev = None
    t0 = time.perf_counter()
    for cam, fr in views:
        out, stats = engine.render_bricked(cam, fr, n_planes=n_planes,
                                           screen_space_error=sse, min_lod=min_lod)
        stats_all.append(stats)
        frames.append(out)
        if prev is not None:
            prev.synchronize()
        prev = mark()
    if prev is not None:
        prev.synchronize()
    return (time.perf_counter() - t0) / len(views), stats_all, frames


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vox", type=int, default=1024)
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--planes", type=int, default=512)
    ap.add_argument("--block", type=int, default=64)
    ap.add_argument("--store", default=None,
                    help="the LOD store (default: ooc_volume_<vox>.lod in the temporary "
                    "directory); built when missing")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "ooc_run.json"))
    ap.add_argument("--incore-mb", type=int, default=1024)
    ap.add_argument("--ooc-mb", type=int, default=96)
    ap.add_argument("--sse", type=float, default=1.0)
    ap.add_argument("--min-lod", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.datasource import DataSource, load_plugins
    from ..data.lod_store import build_lod_store
    from ..render.engine import RenderEngine

    load_plugins()
    device = torch.device(args.device)
    store = args.store or os.path.join(tempfile.gettempdir(), f"ooc_volume_{args.vox}.lod")
    if not os.path.exists(store):
        log(f"building {args.vox}^3 volume ...")
        t0 = time.perf_counter()
        vol = make_volume(args.vox)
        log(f"  volume built in {time.perf_counter() - t0:.1f}s; converting ...")
        t0 = time.perf_counter()
        build_lod_store(vol, store, block_size=args.block, overlap=2)
        log(f"  lod store written in {time.perf_counter() - t0:.1f}s "
            f"({os.path.getsize(store) / 2**20:.0f} MB)")
        del vol

    uri = f"lod://{store}"
    rays = args.img * args.img
    views = orbit_views(args.img, args.frames)
    result = {
        "volume_voxels": args.vox,
        "store_bytes": os.path.getsize(store),
        "img": args.img,
        "planes": args.planes,
        "frames": args.frames,
        "sse": args.sse,
        "min_lod": args.min_lod,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    frames = {}
    for name, budget in (("incore", args.incore_mb), ("out_of_core", args.ooc_mb)):
        eng = RenderEngine(DataSource(uri), max_gpu_cache_mb=budget, max_cpu_cache_mb=2048,
                           device=device)
        dt, stats, frames[name] = run_path(eng, views, args.planes, sse=args.sse,
                                           min_lod=args.min_lod)
        tex = eng.texture_cache.statistics
        data = eng.data_cache.statistics
        result[name] = {
            "budget_mb": budget,
            "ms_per_frame": dt * 1e3,
            "mrays_per_s": rays / dt / 1e6,
            "passes_per_frame": float(np.mean([s.n_passes for s in stats])),
            "bricks_per_frame": float(np.mean([s.n_render_available for s in stats])),
            "atlas_evictions": tex.evictions,
            "atlas_hits": tex.hits,
            "atlas_misses": tex.misses,
            "data_cache_evictions": data.evictions,
        }
        log(f"{name}: {json.dumps(result[name])}")
        if name == "incore":  # K1 on the last frame against its plain version
            cam, fr = views[-1]
            got = []
            for kernels in ((), ("post_sweep",)):
                with plain(*kernels):
                    got.append(eng.render_bricked(cam, fr, n_planes=args.planes,
                                                  screen_space_error=args.sse,
                                                  min_lod=args.min_lod)[0])
            check("post_sweep", *got, "the last in-core frame: K1 vs its plain version",
                  (0.0, 0.0))
        del eng

    for i, (a, b) in enumerate(zip(frames["out_of_core"], frames["incore"])):
        if not torch.equal(a, b):
            raise AssertionError(f"frame {i}: the out-of-core frame is not the in-core frame "
                                 f"bit for bit (max|d| {float((a - b).abs().max())})")
    log(f"every out-of-core frame bit-equal to its in-core frame ({len(views)} frames)")

    ooc, inc = result["out_of_core"], result["incore"]
    result["ooc_vs_incore"] = ooc["mrays_per_s"] / max(inc["mrays_per_s"], 1e-9)
    result["note"] = (
        "per-frame host clock over the measured lap, pipelined one frame deep (a CUDA "
        "event per frame); the atlas takes ATLAS_FRACTION of each budget, and the rest "
        "holds the assembled stores, so the squeezed budget renders in slab passes"
    )
    if ooc["atlas_evictions"] <= 0:
        raise AssertionError("the out-of-core run must evict atlas bricks")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(f"wrote {args.out}")
    print_launches()
    return result


if __name__ == "__main__":
    main()
