"""Slab-sharded (model-parallel) store training (BASELINE config 5; the JAX
package's ``benchmarks/demo_slab_train.py``)::

    python -m libre_tpu_torch.benchmarks.demo_slab_train [--vox 32] \\
        [--steps 6] [--brick 4] [--ray 2] [--device cuda]

Prints (a) the per-device memory table for replicated vs slab-sharded
training: the store plus Adam's two moments replicate (3× the store per
device) unless the store is sharded 1/D on the brick axis; and (b) a run
of the slab trainer (``train.store_trainer.make_slab_train_step``: per
shard K1 forward and K2 backward on its extended slab, the segments
folded in plane order, Adam per slab) over a (``--ray`` × ``--brick``)
mesh of every CUDA device, or of ``--device`` repeated (logical shards of
one device: the decomposition is exercised, the memory is not divided).

Before the run, one step's loss and gradients are held against the
replicated-store loss on the one device (``make_loss_fn``, within
``testing.SHARD_LOSS_RTOL`` and ``SHARD_GRAD_TOL``), and the slab loss's
gradients with the kernels against their plain versions
(``_common.plain``); the loss must fall over the run.  The last two lines
give the checks' largest error and the render kernels' launch counts.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import shearwarp as sw
from ..ops import shearwarp_grad as swg
from ..ops.transfer_function import default_color_map
from ..parallel.mesh import local_devices, make_mesh
from ..testing import SHARD_GRAD_TOL, SHARD_LOSS_RTOL
from ..train import store_trainer as st
from ._common import check_grads, log, plain, print_launches


def memory_table(d_values=(1, 4, 8, 16, 64)):
    """Per-device training memory (GB) for an Na³ f32 store + Adam's
    moments (3× the store) + one halo slice pair; the port's store is
    unpadded."""
    rows = []
    for na in (256, 512, 1024, 2048):
        store_gb = na ** 3 * 4 / 2**30
        for d in d_values:
            per_dev = store_gb * 3 / d + 2 * na * na * 4 / 2**30
            rows.append({
                "na": na, "devices": d,
                "store_plus_adam_gb_per_dev": round(per_dev, 3),
                "fits_80gb": bool(per_dev < 72.0),
            })
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vox", type=int, default=32)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--brick", type=int, default=4)
    ap.add_argument("--ray", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps({"memory_model": memory_table()}))

    device = torch.device(args.device)
    n = args.brick * args.ray
    cards = local_devices() if device.type == "cuda" else ()
    devices = list(cards) if len(cards) >= n else [device] * n
    mesh = make_mesh(n_brick=args.brick, n_ray=args.ray, devices=devices[:n])
    lead = mesh.lead
    log(f"mesh {mesh.shape} on {[str(d) for d in mesh.distinct_devices()]}")

    axis, sign = 2, -1.0
    nv = args.vox
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    rng = np.random.default_rng(0)
    vol = rng.random((nv, nv, nv)).astype(np.float32)
    store = torch.from_numpy(np.ascontiguousarray(np.transpose(vol, sw._PERM[axis]))).to(lead)
    na, nc, nb = store.shape
    tf = torch.from_numpy(default_color_map()).to(lead)
    k_planes, v_size, u_size = 2 * nv, 16, 16
    views = np.stack([
        swg.view_vector(
            world_min=gmin, world_max=gmax, axis=axis, eye=e, sign=sign,
            slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(v_size, u_size),
            max_samples_per_ray=k_planes,
        )
        for e in (np.float32([0.1, 0.05, 1.4]), np.float32([-0.15, 0.1, 1.3]))
    ])
    problem = st.StoreProblem(
        views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb, k_planes=k_planes,
        inter_size=(v_size, u_size), world_min=gmin, world_max=gmax, axis=axis,
        diff_tf=False,
    )
    targets = st.render_views(problem, store, tf).detach()
    init = store.cpu().numpy().copy()
    cov = init > -0.5
    init[cov] = np.clip(init[cov] + rng.normal(0, 0.2, cov.sum()), 0, 1).astype(np.float32)
    init = torch.from_numpy(init).to(lead)
    shard_devs = [mesh.device(0, kd) for kd in range(args.brick)]

    # The first step's loss and gradients against the replicated store's
    # on one device, and with the kernels against their plain versions.
    slab_loss = st.make_slab_loss_fn(problem, mesh)

    def slab_grads():
        slabs = [s.requires_grad_() for s in st.shard_store_slabs_uniform(init, args.brick, shard_devs)]
        loss = slab_loss(slabs, tf, targets)
        loss.backward()
        return float(loss.detach()), torch.cat([s.grad.to(lead) for s in slabs])

    leaf = init.clone().requires_grad_()
    one = st.make_loss_fn(problem)(leaf, tf, targets)
    one.backward()
    loss_k, grad_k = slab_grads()
    with plain("post_sweep", "store_grid_bwd"):
        _loss_p, grad_p = slab_grads()
    check_grads("store_grid_bwd", [grad_k], [grad_p], "slab loss gradient vs plain", 1.1)
    loss_err = abs(loss_k - float(one.detach())) / abs(float(one.detach()))
    grad_err = float((grad_k - leaf.grad).abs().max())
    log(f"slab vs replicated: loss rel {loss_err:.3e}, store gradient max|d| {grad_err:.3e}")
    if loss_err > SHARD_LOSS_RTOL or grad_err > SHARD_GRAD_TOL:
        raise AssertionError(f"slab loss {loss_err} / gradient {grad_err} off the replicated one")

    slabs = [s.requires_grad_() for s in st.shard_store_slabs_uniform(init, args.brick, shard_devs)]
    tf_p = tf.clone().requires_grad_()
    step = st.make_slab_train_step(problem, torch.optim.Adam(slabs + [tf_p], lr=5e-2), mesh)
    losses = [float(step({"slabs": slabs, "tf": tf_p}, targets)) for _ in range(args.steps)]
    out = {
        "mesh": mesh.shape,
        "logical_shards_of_one_device": len(mesh.distinct_devices()) == 1,
        "slab_slices": [int(s.shape[0]) for s in slabs],
        "bytes_per_shard_store": int(slabs[0].numel() * 4),
        "losses": losses,
        "converging": losses[-1] < losses[0],
    }
    print(json.dumps({"functional": out}))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"slab training did not converge: {losses}")
    print_launches()
    return out


if __name__ == "__main__":
    main()
