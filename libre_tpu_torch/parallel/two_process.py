"""A two-process run of a process-spanning mesh: the ray axis across two
processes, the brick axis inside each (``parallel/distributed.py``).

    python -m libre_tpu_torch.parallel.two_process --rank R --port P \\
        [--device cuda] [--vox 256] [--img 256]

Each process joins a two-process ``gloo`` group on 127.0.0.1, takes the
controller's frame state (:func:`distributed.broadcast_frame_state`),
meets the others at a barrier, then:

* renders the whole slope grid of a seeded store on one device, and its
  own block of rows over a local (1 × 2) mesh of logical brick shards of
  ``--device`` (K1 once per shard); the gathered rows
  (:func:`distributed.gather_rows`) must equal the one-device grid
  (``testing.SHARD_TOL_EXIT_OFF``, early exit off);
* computes the slab-sharded store loss of its rows and its TF gradient;
  summed over the processes (:func:`distributed.all_reduce_sum`) they
  must equal the one-device loss (``SHARD_LOSS_RTOL``) and TF gradient
  (``SHARD_GRAD_TOL``).

It prints ``OK rank=R {json}`` on success and exits non-zero otherwise.
:func:`run` starts both processes and returns their outputs; it kills
any process still running when it returns.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
from typing import List

import numpy as np
import torch

WORLD = 2
EYE = (0.1, 0.05, 1.4)


def main(argv=None) -> int:
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.parallel import distributed
    from libre_tpu_torch.parallel.bricked_sharded import render_store_grid_sharded
    from libre_tpu_torch.parallel.mesh import make_mesh
    from libre_tpu_torch.testing import (
        SHARD_GRAD_TOL,
        SHARD_LOSS_RTOL,
        SHARD_TOL_EXIT_OFF,
        smooth_volume,
    )
    from libre_tpu_torch.train import store_trainer as st

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vox", type=int, default=256)
    ap.add_argument("--img", type=int, default=256)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)

    distributed.initialize(f"127.0.0.1:{args.port}", WORLD, args.rank, backend="gloo")
    try:
        sent = {"eye": EYE, "seed": 11, "frame": 0}
        state = distributed.broadcast_frame_state(sent if distributed.is_controller() else None)
        if state != sent:
            raise AssertionError(f"rank {args.rank}: broadcast gave {state}")
        distributed.sync_global_devices("frame 0")

        dev = torch.device(args.device)
        axis, n, img = 2, args.vox, args.img
        store = smooth_volume(n, seed=state["seed"], device=dev).permute(sw._PERM[axis]).contiguous()
        na, nc, nb = store.shape
        tf = torch.from_numpy(default_color_map()).to(dev)
        gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
        k_planes = 2 * n
        fv = swg.view_vector(
            world_min=gmin, world_max=gmax, axis=axis, eye=state["eye"], sign=-1.0,
            slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(img, img),
            max_samples_per_ray=k_planes,
        )
        b_axis, c_axis = sw._BC_AXES[axis]
        kw = dict(na_real=na, nc_real=nc, nb_real=nb, k_planes=k_planes,
                  wb0=float(gmin[b_axis]), wb1=float(gmax[b_axis]),
                  wc0=float(gmin[c_axis]), wc1=float(gmax[c_axis]), early_exit=1.1)
        whole = render_store_grid_sharded(
            make_mesh(1, 1, [dev]), store, tf, fv, inter_size=(img, img), **kw
        )
        rows = distributed.process_rows(img)
        v_l = rows.stop - rows.start
        fv_l = fv.copy()  # this process's rows start at v0 + r·V_l·dv
        fv_l[8] = fv[8] + np.float32(args.rank) * (np.float32(v_l) * fv[5])
        local_mesh = make_mesh(n_brick=2, n_ray=1, devices=[dev] * 2)
        mine = render_store_grid_sharded(local_mesh, store, tf, fv_l, inter_size=(v_l, img), **kw)
        gathered = distributed.gather_rows(mine)
        img_err = float((gathered - whole).abs().max())

        problem = st.StoreProblem(
            views=fv[None], na_store=na, na_real=na, nc_real=nc, nb_real=nb,
            k_planes=k_planes, inter_size=(img, img), world_min=gmin, world_max=gmax,
            axis=axis,
        )
        targets = (whole * 0.8 + 0.05).detach()[None]
        tf_one = tf.clone().requires_grad_()
        loss_one = st.make_loss_fn(problem)(store, tf_one, targets)
        loss_one.backward()
        local = dataclasses.replace(problem, views=fv_l[None], inter_size=(v_l, img))
        tf_mine = tf.clone().requires_grad_()
        slabs = st.shard_store_slabs_uniform(store, 2)
        loss_mine = st.make_slab_loss_fn(local, local_mesh)(slabs, tf_mine, targets[:, rows])
        loss_mine.backward()
        loss = float(distributed.all_reduce_sum(loss_mine.detach())) / WORLD
        d_tf = distributed.all_reduce_sum(tf_mine.grad) / WORLD
        loss_err = abs(loss - float(loss_one.detach())) / abs(float(loss_one.detach()))
        tf_err = float((d_tf - tf_one.grad).abs().max())
        out = {"rank": args.rank, "device": str(dev), "img_err": img_err, "loss": loss,
               "loss_one": float(loss_one.detach()), "loss_rel_err": loss_err,
               "tf_grad_err": tf_err, "tf_grad_max": float(tf_one.grad.abs().max()),
               "alpha_max": float(whole[..., 3].max())}
        if img_err > SHARD_TOL_EXIT_OFF or loss_err > SHARD_LOSS_RTOL or tf_err > SHARD_GRAD_TOL:
            raise AssertionError(f"rank {args.rank}: {out}")
        distributed.sync_global_devices("done")
        print(f"OK rank={args.rank} {json.dumps(out)}", flush=True)
    finally:
        distributed.shutdown()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(device: str, vox: int, img: int, timeout: float) -> List[str]:
    """Start both processes (this interpreter, this checkout on the path)
    and return their outputs; raise if either fails or times out."""
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "libre_tpu_torch.parallel.two_process", "--rank", str(r),
             "--port", str(port), "--device", device, "--vox", str(vox), "--img", str(img)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root,
        )
        for r in range(WORLD)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"OK rank={r}" not in out:
            raise RuntimeError(f"two_process rank {r} exited {p.returncode}:\n{out[-4000:]}")
    return outs


if __name__ == "__main__":
    sys.exit(main())
