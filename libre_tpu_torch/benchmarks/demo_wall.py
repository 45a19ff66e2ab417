"""Multi-view wall throughput (the JAX package's ``benchmarks/demo_wall.py``):
the service's layouts (1x2, 2x2) of a ``mem://`` volume through
``RenderEngine.render_wall`` (one device canvas, no host synchronisation
between views) against the sequential loop of ``render_bricked`` over the
same views, and a single full-size view::

    python -m libre_tpu_torch.benchmarks.demo_wall [--img 256] [--vox 64] \\
        [--frames 20] [--out libre_tpu_torch/_build/wall_run.json]

Every frame is timed with CUDA events around ``--frames`` steady frames
after a warm-up (``_common.timed``; on ``--device cpu``, a tiny rehearsal,
by the host clock).  Each layout's canvas tiles must equal the sequential
frames of their views bit for bit (``tile_parity_max_abs``, 0.0), and one
wall must equal the same wall with K1's plain version (``_common.plain``);
a difference raises.  The JSON record has the reference's keys; its
default path lies in the kernels' build directory, which is not
committed.  The last two lines give the check's largest error and the
render kernels' launch counts (the check's launches not counted).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..ops import _kernels
from ._common import check, log, plain, print_launches, synchronize, timed

N_PLANES = 256


def make_view(vw, vh, az_deg):
    """The reference's wall camera: eye (0.2, 0.1, 1.4) rotated by
    ``az_deg`` about y, a 50° perspective over (vw, vh)."""
    from ..core.frustum import Frustum, look_at, perspective
    from ..ops.reference import Camera

    rad = np.deg2rad(az_deg)
    c, s = np.cos(rad), np.sin(rad)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float32)
    mv0 = look_at([0.2, 0.1, 1.4], [0, 0, 0], [0, 1, 0])
    mv = (mv0.astype(np.float64) @ rot.astype(np.float64)).astype(np.float32)
    proj = perspective(50.0, vw / vh, 0.1, 15.0)
    fr = Frustum(mv, proj)
    cam = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, vw, vh),
        near=fr.near,
    )
    return cam, fr


def layouts(w, h):
    """The service's layouts as (dx, dy, vw, vh, azimuth) tiles."""
    return {
        "1x2": [(0, 0, w // 2, h, 0.0), (w // 2, 0, w - w // 2, h, 90.0)],
        "2x2": [
            (0, 0, w // 2, h // 2, 0.0),
            (w // 2, 0, w - w // 2, h // 2, 90.0),
            (0, h // 2, w // 2, h - h // 2, 180.0),
            (w // 2, h // 2, w - w // 2, h - h // 2, 270.0),
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default=str(_kernels.BUILD_DIR / "wall_run.json"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..data.datasource import DataSource, load_plugins
    from ..render.engine import RenderEngine

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("demo_wall: no CUDA device (pass --device cpu for a rehearsal)")
    load_plugins()
    eng = RenderEngine(
        DataSource(f"mem://#{args.vox},{args.vox},{args.vox},32"),
        max_gpu_cache_mb=1024, filter_mode="trilinear", device=dev,
    )
    w = h = args.img
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"img": args.img, "vox": args.vox, "device": kind}

    cam1, fr1 = make_view(w, h, 15.0)
    single_s, _ = timed(lambda: eng.render_bricked(cam1, fr1, n_planes=N_PLANES)[0], dev,
                        iters=args.frames)
    single_ms = single_s * 1e3
    log(f"single view: {single_ms:.3f} ms/frame")
    result["single_view_ms"] = single_ms

    for name, tiles in layouts(w, h).items():
        views = [(*make_view(vw, vh, az), (dx, dy)) for dx, dy, vw, vh, az in tiles]

        def wall():
            return eng.render_wall(views, (h, w), n_planes=N_PLANES)[0]

        def sequential():
            return [eng.render_bricked(cam, fr, n_planes=N_PLANES)[0] for cam, fr, _ in views]

        wall_s, canvas = timed(wall, dev, iters=args.frames)
        seq_s, frames = timed(sequential, dev, iters=args.frames)
        wall_ms, seq_ms = wall_s * 1e3, seq_s * 1e3
        n = len(views)
        per_view_ms = wall_ms / n
        parity = max(
            float((canvas[dy : dy + vh, dx : dx + vw] - img).abs().max())
            for (dx, dy, vw, vh, _az), img in zip(tiles, frames)
        )
        result[name] = {
            "views": n,
            "wall_ms_per_frame": wall_ms,
            "sequential_ms_per_frame": seq_ms,
            "per_view_ms": per_view_ms,
            "per_view_rate_vs_single": single_ms / per_view_ms,
            "speedup_vs_sequential": seq_ms / max(wall_ms, 1e-9),
            "tile_parity_max_abs": parity,
        }
        log(f"{name}: wall {wall_ms:.3f} ms vs sequential {seq_ms:.3f} ms "
            f"({result[name]['speedup_vs_sequential']:.3f}x); per view {per_view_ms:.3f} ms "
            f"vs single {single_ms:.3f} ms; tiles vs sequential max |d| {parity}")
        if parity != 0.0:
            raise AssertionError(f"{name}: a wall tile differs from its sequential frame "
                                 f"by {parity}")
        with plain("post_sweep"):
            want = wall()
        synchronize(dev)
        check("post_sweep", canvas, want, f"{name} wall vs plain K1", (0.0, 0.0))

    result["criterion_per_view_rate_ge_half_single"] = all(
        result[k]["per_view_rate_vs_single"] >= 0.5 for k in ("1x2", "2x2")
    )
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out}")
    print(json.dumps(result), flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
