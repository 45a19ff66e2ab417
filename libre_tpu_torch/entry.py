"""Entry point of the port (``__graft_entry__.entry``'s counterpart).

:func:`entry` returns ``(fn, example_args)``: the forward render of the
flagship path, the exact marcher (K3, ``csrc/exact_march.cu``) over a
single-brick 32³ volume, 128 samples per ray, into a 128² image
(BASELINE config 1), with its example inputs made from a seed.
:func:`dryrun_multichip` (``__graft_entry__.dryrun_multichip``'s
counterpart) runs each sharded path once on tiny shapes over a (ray ×
brick) mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

IMG, N_VOX, SPR = 128, 32, 128


def _camera(img, near=0.1, far=15.0):
    from libre_tpu_torch.core.frustum import look_at, perspective
    from libre_tpu_torch.ops.reference import Camera

    proj = perspective(50.0, 1.0, near, far)
    mv = look_at([0, 0, 1.0], [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=near,
    )


def entry(device="cuda"):
    """(fn, example_args): ``fn(volume (Z, Y, X) f32, tf (T, 4) f32)`` →
    the (H, W, 4) image, bottom-up rows, through ``exact.render_exact``
    (K3 on a CUDA tensor, its runtime-T instance for T ≠ 256; its plain
    version on a CPU one); the example volume and TF lie on ``device``.
    The example TF is the reference's: the 64-entry default colormap."""
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.ops.transfer_function import default_color_map

    cam = _camera(IMG)
    params = RenderParams(
        n_samples_per_ray=SPR,
        data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * SPR)) + 4,
    )

    def fn(volume, tf):
        return exact.render_exact(volume.contiguous(), tf.contiguous(), cam, params)

    rng = np.random.default_rng(0)
    example_args = (
        torch.from_numpy(rng.random((N_VOX,) * 3, dtype=np.float32)).to(device),
        torch.from_numpy(default_color_map(64)).to(device),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None, exact_trainer: bool = False) -> dict:
    """Run each sharded path once over an ``n_devices`` (ray × brick) mesh
    on tiny shapes and return what each printed: the exact march (K3 per
    shard) of a 16³ volume in 8 bricks, with ``exact_trainer`` one Adam
    step of the mesh-sharded exact trainer on it (K3 and K4 per shard),
    the bricked store sweep (K1 per shard, sort-first rows × sort-last
    plane ranges), one step of the replicated-store trainer and the
    slab-sharded loss and gradients (K1 and K2 per shard), and
    ``render_cli --mesh``.

    ``devices`` (default: every CUDA device) may repeat one device.  The
    brick axis has 2 shards when ``n_devices`` is even.  The exact
    trainer starts from the 32-entry default colormap, as the JAX dry run
    (K3 and K4 through their runtime-T instances on the card)."""
    import tempfile

    from libre_tpu_torch.apps import render_cli
    from libre_tpu_torch.ops import rays as ray_ops
    from libre_tpu_torch.ops import shearwarp as sw
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.ops.reference import RenderParams, max_steps_for_bricks
    from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL
    from libre_tpu_torch.ops.transfer_function import default_color_map
    from libre_tpu_torch.parallel import make_mesh
    from libre_tpu_torch.parallel.bricked_sharded import render_store_grid_sharded
    from libre_tpu_torch.parallel.mesh import local_devices
    from libre_tpu_torch.parallel.render import render_rays_sharded, shard_bricks_front_to_back
    from libre_tpu_torch.testing import split_into_bricks
    from libre_tpu_torch.train import store_trainer as st
    from libre_tpu_torch.train.trainer import InverseRenderProblem, init_state, make_train_step

    devices = list(local_devices() if devices is None else devices)[:n_devices]
    n_brick = 2 if n_devices % 2 == 0 else 1
    n_ray = n_devices // n_brick
    mesh = make_mesh(n_brick=n_brick, n_ray=n_ray, devices=devices)
    lead = mesh.lead
    out = {"mesh": mesh.shape}

    # ---- the exact march: sort-first ray rows x sort-last brick ranges ----
    img = 16 * n_ray  # the ray axis splits the img rows evenly
    cam = _camera(img)
    rng = np.random.default_rng(0)
    volume = rng.random((16,) * 3, dtype=np.float32)
    bricks = split_into_bricks(volume, 2, overlap=2, device=lead)
    eye, dirs, cos_z, _ = ray_ops.make_rays(cam.inv_proj, cam.inv_mv, cam.viewport, device=lead)
    dirs = dirs.reshape(-1, 3)
    tnp = ray_ops.near_plane_t(cos_z.reshape(-1), cam.near)
    sharded, _ = shard_bricks_front_to_back(bricks, eye.cpu().numpy(), n_brick)
    params = RenderParams(
        n_samples_per_ray=16, data_source_range=(0.0, 1.0), filter_mode="trilinear",
        early_exit=1.1,
    )
    gmin, gmax = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    max_steps = max_steps_for_bricks(
        bricks.world_min.cpu().numpy(), bricks.world_max.cpu().numpy(), params.step_size
    )
    tf = torch.from_numpy(default_color_map()).to(lead)
    march = render_rays_sharded(
        mesh, sharded, tf, eye, dirs, tnp, params, gmin, gmax, max_steps, width=img
    )
    out["exact_alpha_max"] = float(march[:, 3].max())
    print(f"dryrun_multichip({n_devices}): sharded exact march alpha_max="
          f"{out['exact_alpha_max']:.4f}")
    if exact_trainer:
        problem = InverseRenderProblem(
            bricks=sharded, global_min=gmin, global_max=gmax, params=params,
            max_steps=max_steps, width=img,
        )
        adam = functools.partial(torch.optim.Adam, lr=1e-2)
        state = init_state(problem, default_color_map(32), adam, mesh=mesh)
        step = make_train_step(problem, adam, mesh)
        loss = step(state, eye, dirs, tnp, torch.zeros((dirs.shape[0], 4), device=lead))
        out["exact_train_loss"] = float(loss)
        print(f"dryrun_multichip({n_devices}): marcher trainer loss="
              f"{out['exact_train_loss']:.6f}")

    # ---- the bricked store sweep: sort-first rows x sort-last plane slabs ----
    axis, sign = 2, -1.0
    k_planes, v_size, u_size = 32, 2 * n_devices, 8
    store = torch.from_numpy(np.ascontiguousarray(np.transpose(volume, sw._PERM[axis])))
    na, nc, nb = store.shape
    store = store.to(lead)
    fv = swg.view_vector(
        world_min=gmin, world_max=gmax, axis=axis, eye=np.float32([0.1, 0.05, 1.4]),
        sign=sign, slope_bounds=(-0.45, 0.45, -0.4, 0.4), inter_size=(v_size, u_size),
        max_samples_per_ray=k_planes,
    )
    b_axis, c_axis = sw._BC_AXES[axis]
    frame = render_store_grid_sharded(
        mesh, store, tf, fv, na_real=na, nc_real=nc, nb_real=nb, k_planes=k_planes,
        inter_size=(v_size, u_size), wb0=float(gmin[b_axis]), wb1=float(gmax[b_axis]),
        wc0=float(gmin[c_axis]), wc1=float(gmax[c_axis]), early_exit=0.999,
    )
    out["bricked_alpha_max"] = float(frame[..., 3].max())
    print(f"dryrun_multichip({n_devices}): bricked sharded render alpha_max="
          f"{out['bricked_alpha_max']:.4f}")

    # ---- the store trainer, replicated store: views x rows over the mesh ----
    problem = st.StoreProblem(
        views=np.stack([fv] * n_brick), na_store=na, na_real=na, nc_real=nc, nb_real=nb,
        k_planes=k_planes, inter_size=(v_size, u_size), world_min=gmin, world_max=gmax,
        axis=axis,
    )
    targets = st.render_views(problem, store, tf).detach()
    init = torch.where(store > -0.5, 0.5, SENTINEL)
    _params, losses = st.fit(problem, targets, init, tf, device=lead, mesh=mesh, steps=1)
    out["store_loss"] = losses[0]
    print(f"dryrun_multichip({n_devices}): store trainer loss={losses[0]:.6f}")

    # ---- the slab-sharded store trainer: the store 1/d_k per shard ----
    if n_brick > 1:
        slab_problem = dataclasses.replace(problem, views=fv[None])
        slabs = [s.requires_grad_() for s in st.shard_store_slabs_uniform(store, n_brick, [
            mesh.device(0, kd) for kd in range(n_brick)])]
        tf_p = tf.clone().requires_grad_()
        loss = st.make_slab_loss_fn(slab_problem, mesh)(slabs, tf_p, targets[:1] * 0.9)
        loss.backward()
        out["slab_loss"] = float(loss.detach())
        out["slab_grad_max"] = max(float(s.grad.abs().max()) for s in slabs)
        print(f"dryrun_multichip({n_devices}): slab-sharded trainer loss={out['slab_loss']:.6f} "
              f"|g_store|={out['slab_grad_max']:.4f}")

    # ---- the app on the mesh: render_cli routes through the sharded frame ----
    with tempfile.TemporaryDirectory() as td:
        rc = render_cli.main([
            "--volume", "mem://#16,16,16,8", "--width", "32", "--height", "32",
            "--mesh", f"{n_ray}x{n_brick}", "--mesh-devices", ",".join(map(str, devices)),
            "--device", str(lead), "--sse", "2", "--output-dir", td,
        ])
    if rc != 0:
        raise RuntimeError(f"render_cli --mesh exited {rc}")
    print(f"dryrun_multichip({n_devices}): render_cli --mesh ok")
    return out
