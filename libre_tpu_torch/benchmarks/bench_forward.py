"""Forward and backward throughput of the exact marcher against the
oracle (the JAX package's ``benchmarks/bench_forward.py``)::

    python -m libre_tpu_torch.benchmarks.bench_forward [--quick]

Rows, as the reference's: "fast" is the port's marcher route, a
``models.VolumeScene`` over one random brick (forward K3,
``csrc/exact_march.cu``; "bwd" takes ``torch.autograd`` of the mean
squared image through ``exact.render_marcher_diff``, backward K4 with the
early exit on, as the reference's ``jax.grad`` of ``raycast.render``);
"oracle" is the plain per-sample marcher ``reference.render_reference``
(the reference's "ref" rows).  Each row is timed by CUDA events over
``--iters`` calls after a warm-up, ended by a synchronise.  Then each
"fast" row's output is held against the same call with its kernel's
plain version (``_common.plain``: K3's image within
``testing.EXACT_TOL_MAX``/``EXACT_TOL_MEAN``, K4's gradients within the
backward kernels' early-exit bound), and the oracle row's image against
the "fast" row's of the same size; a disagreement raises.

Left out: the reference's ``chunk`` column and its chunk sweep, a tile
knob of the TPU marcher with no counterpart (K3 walks each ray's samples
one by one); the two rows that differed only by it are one row here.
``--vox``, ``--img`` and ``--spr`` override every row's size, for a
smoke run; ``--device cpu`` times the plain versions on the host clock.
The last two lines give the checks' largest error and the render
kernels' launch counts (the checks' launches not counted).
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..apps.render_cli import build_camera
from ..models import VolumeScene
from ..ops.reference import RenderParams, render_reference, single_brick_set
from ..ops.transfer_function import default_color_map
from ..testing import EXACT_TOL_MAX, EXACT_TOL_MEAN
from ._common import check, check_grads, plain, print_launches, timed

GMIN = np.float32([-0.5] * 3)
GMAX = np.float32([0.5] * 3)


def bench(n_vox, img, spr, filter_mode, mode, which, device, iters) -> Tuple[Dict, object]:
    """(the row, the last output: the image, or the gradients for "bwd")."""
    rng = np.random.default_rng(0)
    vol = rng.random((n_vox,) * 3, dtype=np.float32)
    cam = build_camera(img, img, (0.0, 0.0, 1.0), (0.0, 0.0, 0.0))[0]
    params = RenderParams(
        n_samples_per_ray=spr,
        data_source_range=(0.0, 1.0),
        filter_mode=filter_mode,
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * spr)) + 4,
    )
    scene = VolumeScene.from_volume(vol, default_color_map(256), params, device=device)

    if which == "fast":
        def render(s):
            return s.render(cam)
    else:
        def render(s):
            return render_reference(single_brick_set(s.bricks.data[0]), s.tf, cam, params,
                                    GMIN, GMAX)

    if mode == "fwd":
        def f():
            with torch.no_grad():
                return render(scene)
    else:
        leaves = {k: v.detach().clone().requires_grad_() for k, v in scene.parameters.items()}

        def f():
            loss = torch.mean(render(scene.with_parameters(leaves)) ** 2)
            return torch.autograd.grad(loss, [leaves["density"], leaves["tf"]])

    dt, out = timed(f, device, iters)
    rays = img * img
    label = "oracle" if which == "ref" else which
    size = f"vol={n_vox}^3 img={img}^2 spr={spr} {filter_mode}"
    if which == "fast":
        kernel = "exact_march" if mode == "fwd" else "exact_march_bwd"
        with plain(kernel):
            want = f()
        what = f"{mode} {size}: the {kernel} kernel vs its plain version"
        if mode == "fwd":
            check(kernel, out, want, what, (EXACT_TOL_MAX, EXACT_TOL_MEAN))
        else:
            check_grads(kernel, out, want, what, params.early_exit)
    print(
        f"{label:6s} {mode} vol={n_vox}^3 img={img}^2 spr={spr} {filter_mode:9s}: "
        f"{dt * 1e3:8.2f} ms  {rays / dt / 1e6:8.2f} Mrays/s  "
        f"{rays * spr * 1.75 / dt / 1e9:7.2f} Gsamples/s",
        flush=True,
    )
    return dict(which=label, mode=mode, n_vox=n_vox, img=img, spr=spr,
                filter_mode=filter_mode, ms=dt * 1e3, mrays_per_s=rays / dt / 1e6), out


def rows(quick: bool):
    """The reference's rows as (n_vox, img, spr, filter, mode, which)."""
    out = [(64, 256, 512, "nearest", "fwd", w) for w in ("fast", "ref")]
    out.append((64, 256, 512, "trilinear", "fwd", "fast"))
    if not quick:
        out += [
            (128, 512, 1024, "nearest", "fwd", "fast"),
            (128, 512, 1024, "trilinear", "fwd", "fast"),
            (64, 256, 512, "trilinear", "bwd", "fast"),
        ]
    return out


def main(argv=None) -> List[Dict]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--vox", type=int, default=None)
    p.add_argument("--img", type=int, default=None)
    p.add_argument("--spr", type=int, default=None)
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print("device:", torch.cuda.get_device_name(device), flush=True)
    results, fast = [], {}
    for n_vox, img, spr, filter_mode, mode, which in rows(args.quick):
        size = (args.vox or n_vox, args.img or img, args.spr or spr, filter_mode, mode)
        row, out = bench(*size, which, device, args.iters)
        results.append(row)
        if which == "fast":
            fast[size] = out
        elif size in fast:  # the oracle's image against the kernel's
            check("exact_march", fast[size], out, f"{size}: fast vs oracle",
                  (EXACT_TOL_MAX, EXACT_TOL_MEAN))
    print_launches()
    return results


if __name__ == "__main__":
    main()
