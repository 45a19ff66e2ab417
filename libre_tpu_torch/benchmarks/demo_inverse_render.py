"""Inverse-rendering demo (BASELINE config 5; the JAX package's
``benchmarks/demo_inverse_render.py``): recover a density store from
multi-view target images::

    python -m libre_tpu_torch.benchmarks.demo_inverse_render [--vox 64] \\
        [--img 64] [--planes 96] [--steps 50] [--views 4] [--exact]

The store path runs the store trainer (``train.fit``: per view
``render_store_grid_diff``, forward K1 ``csrc/post_sweep.cu``, backward
K2 ``csrc/store_grid_bwd.cu``; Adam).  ``--exact`` optimizes a density
volume through the exact marcher instead (``train.make_exact_train_step``:
``render_exact_diff``, forward K3 ``csrc/exact_march.cu``, backward K4
``csrc/exact_march_bwd.cu``), one view per step in turn.  The wall time
ends with a synchronise; ``--device cpu`` runs the plain versions.

Before the fit, one call of each kernel the fit runs is held against the
same call with its plain version (``_common.plain``), at the initial
parameters: the views' render (K1 bit-equal, K3 within
``testing.EXACT_TOL_MAX``/``EXACT_TOL_MEAN``) and the loss's gradients
(K2, K4 within the backward kernels' bound); a disagreement raises.  The
reference's ``interpret`` switch (Pallas interpret mode off the TPU) has
no counterpart.  The last two lines give the checks' largest error and
the render kernels' launch counts (the checks' launches not counted).
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Dict

import numpy as np
import torch

from ..apps.render_cli import build_camera
from ..ops import exact
from ..ops import shearwarp as sw
from ..ops import shearwarp_grad as swg
from ..ops.reference import RenderParams
from ..ops.shearwarp_bricked import SENTINEL
from ..ops.transfer_function import default_color_map
from ..train import store_trainer as st
from ..testing import EXACT_TOL_MAX, EXACT_TOL_MEAN, smooth_volume
from ..train.trainer import init_exact_state, make_exact_train_step
from ._common import check, check_grads, log, plain, print_launches, synchronize

GMIN, GMAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)
AXIS, SIGN = 2, -1.0
EYES = [
    [0.1, 0.05, 1.4], [-0.15, 0.1, 1.3],
    [0.02, -0.12, 1.5], [-0.05, -0.02, 1.2],
]
BOUNDS = (-0.45, 0.45, -0.4, 0.4)
SEED = 7  # the demo's own smooth volume (benchmarks/demo_inverse_render.py:41)


def check_kernels(render, loss, params, tf, fwd, bwd, fwd_tol, early_exit) -> None:
    """Hold ``render(params, tf)`` with the ``fwd`` kernel against the
    same call with its plain version, and the gradients of
    ``loss(params, tf)`` in both leaves with the ``bwd`` kernel against
    its plain version's."""
    def grads():
        leaves = [params.detach().clone().requires_grad_(), tf.detach().clone().requires_grad_()]
        return torch.autograd.grad(loss(*leaves), leaves)

    outs, dxs = [], []
    for kernels in ((), (fwd,)):
        with plain(*kernels), torch.no_grad():
            outs.append(render(params, tf))
    for kernels in ((), (bwd,)):
        with plain(*kernels):
            dxs.append(grads())
    check(fwd, *outs, f"{fwd} vs its plain version, the initial parameters", fwd_tol)
    check_grads(bwd, *dxs, f"{bwd} vs its plain version, the initial loss", early_exit)


def main_exact(args, device) -> Dict:
    """Inverse rendering with reference-exact perspective sampling: the
    targets rendered and differentiated through ``render_exact_diff``."""
    n, img, spr = args.vox, args.img, args.planes
    params = RenderParams(
        n_samples_per_ray=spr, data_source_range=(0.0, 1.0),
        filter_mode="trilinear", early_exit=1.1,
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * spr)) + 4,
    )
    views = [exact.exact_view(build_camera(img, img, e, (0.0, 0.0, 0.0))[0], params, GMIN,
                              GMAX, device=device)
             for e in EYES[: args.views]]
    vol_gt = smooth_volume(n, SEED, device=device)
    tf = torch.from_numpy(default_color_map(256)).to(device)
    with torch.no_grad():
        targets = [exact.render_exact_diff(vol_gt, tf, v) for v in views]
    state = init_exact_state(np.full((n, n, n), 0.5, np.float32), tf,
                             lambda p: torch.optim.Adam(p, lr=args.lr), device=device)
    steps = [make_exact_train_step(v) for v in views]
    init = state.params["density"].detach()
    check_kernels(lambda x, t: exact.render_exact_diff(x, t, views[0]),
                  lambda x, t: torch.mean((exact.render_exact_diff(x, t, views[0])
                                           - targets[0]) ** 2),
                  init, tf, "exact_march", "exact_march_bwd", (EXACT_TOL_MAX, EXACT_TOL_MEAN),
                  params.early_exit)
    synchronize(device)
    t0 = time.perf_counter()
    losses, at = [], []
    for s in range(args.steps):
        losses.append(float(steps[s % len(views)](state, targets[s % len(views)])))
        at.append(time.perf_counter())
    synchronize(device)
    dt = time.perf_counter() - t0
    first, loss = losses[0], losses[-1]
    err = float((state.params["density"].detach() - vol_gt).abs().mean())
    print(
        f"exact inverse render: view loss {first:.5f} -> {loss:.6f}, mean |density err| "
        f"{err:.4f}, {args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step "
        f"incl host; {_steady_ms(t0, at):.2f} ms median of steps 2-{args.steps})",
        flush=True,
    )
    return dict(first=first, last=loss, density_err=err, seconds=dt)


def _steady_ms(t0, at) -> float:
    """The median step time of steps 2 to N (each step ends in a
    synchronise: its loss is read), ms; the first step loads the kernels."""
    return float(np.median(np.diff([t0] + at)[1:])) * 1e3 if len(at) > 1 else float("nan")


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--img", type=int, default=64)
    ap.add_argument("--planes", type=int, default=96)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--exact", action="store_true",
                    help="optimize through the exact perspective marcher "
                    "(render_exact_diff: K3 forward, K4 backward) instead of "
                    "the shear-warp store path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    log("device:", device)

    if args.exact:
        result = main_exact(args, device)
        print_launches()
        return result
    V = U = args.img
    views = np.stack([
        swg.view_vector(
            world_min=GMIN, world_max=GMAX, axis=AXIS, eye=np.float32(e), sign=SIGN,
            slope_bounds=BOUNDS, inter_size=(V, U), max_samples_per_ray=args.planes,
        )
        for e in EYES[: args.views]
    ])
    store_gt = smooth_volume(args.vox, SEED, device=device).permute(sw._PERM[AXIS]).contiguous()
    na, nc, nb = store_gt.shape
    tf = torch.from_numpy(default_color_map(256)).to(device)
    problem = st.StoreProblem(
        views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=args.planes, inter_size=(V, U), world_min=GMIN, world_max=GMAX,
        axis=AXIS, diff_tf=True,
    )
    with torch.no_grad():
        targets = st.render_views(problem, store_gt, tf)
    init = torch.where(store_gt > -0.5, 0.5, SENTINEL).to(torch.float32)
    loss_fn = st.make_loss_fn(problem)
    check_kernels(lambda x, t: st.render_views(problem, x, t),
                  lambda x, t: loss_fn(x, t, targets), init, tf, "post_sweep",
                  "store_grid_bwd", (0.0, 0.0), problem.static_for(V).early_exit)
    synchronize(device)
    at = []
    t0 = time.perf_counter()
    _params, losses = st.fit(
        problem, targets, init, tf, device=device,
        optimizer=lambda p: torch.optim.Adam(p, lr=args.lr), steps=args.steps,
        on_step=lambda i, loss: at.append(time.perf_counter()),
    )
    synchronize(device)
    dt = time.perf_counter() - t0
    print(
        f"loss {losses[0]:.5f} -> {losses[-1]:.6f} in {args.steps} steps, {dt:.1f}s wall "
        f"({dt / args.steps * 1e3:.0f} ms/step incl host; {_steady_ms(t0, at):.2f} ms median "
        f"of steps 2-{args.steps})",
        flush=True,
    )
    print_launches()
    return dict(first=losses[0], last=losses[-1], seconds=dt)


if __name__ == "__main__":
    main()
