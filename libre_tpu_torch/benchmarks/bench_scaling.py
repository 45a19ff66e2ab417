"""Scaling benchmark: rays/s vs shard count (BASELINE config 4; the JAX
package's ``benchmarks/bench_scaling.py``)::

    python -m libre_tpu_torch.benchmarks.bench_scaling [--devices 4] \\
        [--brick 2] [--img 256] [--planes 512] [--vox 64] \\
        [--path bricked|dense] [--device cuda]

Renders the same frame sharded over 1, 2, 4, ... shards (sort-first
slope rows × sort-last plane ranges when ``--brick`` divides the count):
``--path bricked`` the store sweep (``parallel.bricked_sharded``, K1 per
shard), ``dense`` the classified stack (``shearwarp_dense.
render_slope_grid_sharded``, K5 per shard).  Each frame is timed by CUDA
events (the host clock on the CPU) and held against the one-shard frame
(``testing.SHARD_TOL_EXIT_ON``).

With fewer CUDA devices than shards the mesh repeats the first one: the
rows then say ``"logical_shards_of_one_card": true`` and measure the
decomposition's cost on one card (more launches, the fold), NOT scaling;
``efficiency`` is printed only for meshes of distinct cards.  The last
line is the analytic model of the bytes each brick-axis shard moves per
frame and step, a prediction at ``--link-gbps``, not a measurement.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..apps.render_cli import build_camera
from ..ops import shearwarp as sw
from ..ops import shearwarp_dense as swd
from ..ops import shearwarp_grad as swg
from ..ops.reference import RenderParams
from ..ops.transfer_function import default_color_map
from ..parallel.bricked_sharded import render_store_grid_sharded
from ..parallel.mesh import local_devices, make_mesh
from ..testing import SHARD_TOL_EXIT_ON
from ._common import log, print_launches, timed


def comm_model(*, img: int, na: int, t_kernel_ms: float, device_counts, link_gbps: float):
    """Bytes per device per frame / training step on the brick axis (the
    ray axis moves none until its final gather): the direct-send fold
    moves 4·R·4·(D−1)/D bytes per device, a slab-training step adds two
    halo slices and the TF gradient's sum per view; predicted efficiency
    t_comp / (t_comp + t_comm) with t_comp = t_kernel / D."""
    r_bytes = img * img * 4
    rows = []
    for d in device_counts:
        fold = 4 * (d - 1) / d * r_bytes
        step = fold + 2 * na * na * 4 + 2 * (d - 1) / d * 256 * 4 * 4 if d > 1 else 0.0
        t_comp = t_kernel_ms / d
        rows.append(dict(
            devices=d, frame_bytes_per_dev=int(fold), step_bytes_per_dev=int(step),
            predicted_frame_eff=round(t_comp / (t_comp + fold / (link_gbps * 1e6)), 3),
            predicted_step_eff=round(t_comp / (t_comp + step / (link_gbps * 1e6)), 3),
        ))
    return dict(model="bytes per device on the brick axis; a prediction", link_gbps=link_gbps,
                t_kernel_1dev_ms=t_kernel_ms, rows=rows)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4, help="largest shard count")
    ap.add_argument("--brick", type=int, default=2, help="sort-last factor per run")
    ap.add_argument("--img", type=int, default=256)
    ap.add_argument("--planes", type=int, default=512)
    ap.add_argument("--vox", type=int, default=64)
    ap.add_argument("--path", default="bricked", choices=["bricked", "dense"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--link-gbps", type=float, default=450.0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cards = list(local_devices()) if device.type == "cuda" else []
    img, spr, nv = args.img, args.planes, args.vox
    rng = np.random.default_rng(0)
    vol = torch.from_numpy(rng.random((nv,) * 3, dtype=np.float32)).to(device)
    tf = torch.from_numpy(default_color_map()).to(device)
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    cam, _frustum = build_camera(img, img, (0.2, 0.1, 1.4), (0.0, 0.0, 0.0))
    plan = sw.make_plan(cam)
    params = RenderParams(n_samples_per_ray=spr, data_source_range=(0.0, 1.0))
    swp = sw.ShearWarpParams(n_planes=spr, inter_size=(img, img))
    axis = plan.axis
    b_axis, c_axis = sw._BC_AXES[axis]
    if args.path == "bricked":
        store = vol.permute(sw._PERM[axis]).contiguous()
        na, nc, nb = store.shape
        fv = torch.from_numpy(swg.view_vector(
            world_min=gmin, world_max=gmax, axis=axis, eye=plan.eye, sign=plan.sign,
            slope_bounds=plan.bounds, inter_size=(img, img), max_samples_per_ray=spr,
        )).to(device)

        def render(mesh):
            return render_store_grid_sharded(
                mesh, store, tf, fv, na_real=na, nc_real=nc, nb_real=nb, k_planes=spr,
                inter_size=(img, img), wb0=float(gmin[b_axis]), wb1=float(gmax[b_axis]),
                wc0=float(gmin[c_axis]), wc1=float(gmax[c_axis]), early_exit=0.999,
            )
    else:
        chans = swd.classify_planes(vol, tf, axis, params.data_source_range)
        pa = swd.slope_grid_plan_args(plan, gmin, gmax, params, swp)
        nc, nb = chans.shape[1:3]

        def render(mesh):
            return swd.render_slope_grid_sharded(mesh, chans, nc, nb, pa)

    rows, base, ref = [], None, None
    n = 1
    while n <= args.devices:
        n_brick = args.brick if n % args.brick == 0 else 1
        devices = cards[:n] if len(cards) >= n else [device] * n
        mesh = make_mesh(n_brick=n_brick, n_ray=n // n_brick, devices=devices)
        logical = len(mesh.distinct_devices()) < n
        secs, out = timed(lambda: render(mesh), device)
        if ref is None:
            ref = out
        err = float((out - ref).abs().max())
        if err > SHARD_TOL_EXIT_ON:
            raise AssertionError(f"{n} shards: {err} from the one-shard frame")
        mrays = img * img / secs / 1e6
        base = mrays if base is None else base
        row = {"shards": n, "mesh": mesh.shape, "mrays_per_s": mrays, "ms": secs * 1e3,
               "max_abs_err_vs_1": err, "logical_shards_of_one_card": logical,
               "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
        if not logical and n > 1:
            row["efficiency"] = mrays / (base * n)
        rows.append(row)
        print(json.dumps(row), flush=True)
        n *= 2
    if rows[-1]["logical_shards_of_one_card"]:
        log("NOTE: logical shards of one card: the rows measure the decomposition, not scaling")
    print(json.dumps({"comm_model": comm_model(
        img=img, na=nv, t_kernel_ms=rows[0]["ms"], device_counts=[1, 2, 4, 8, 16, 64],
        link_gbps=args.link_gbps,
    )}), flush=True)
    print_launches()
    return rows


if __name__ == "__main__":
    main()
