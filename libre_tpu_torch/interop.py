"""State carried across from the JAX package, as numpy arrays.

The JAX package lays its device state out for the TPU: the brick atlas
is flat slots padded to 128 lanes, and the assembled store (whole or in
slabs) and the classified plane stack pad their two in-plane axes to
multiples of 128 (the stack also stacks its four channels along c).  These functions
strip that padding
so the port and the JAX package can be fed the same state; the
transfer function, the exact trainer's (Z, Y, X) density and the scene's
(N, BZ, BY, BX) brick stack need no conversion; the mesh-sharded exact
trainer's brick-sharded density becomes one chunk per brick shard.
Results are writable copies, so ``torch.from_numpy`` can take them
(the mesh-sharded trainer's helpers return tensors on the mesh's
devices).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops.reference import BrickSet, RenderParams
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, Mesh, make_mesh
from libre_tpu_torch.train.shearwarp_trainer import ShearWarpProblem
from libre_tpu_torch.train.store_trainer import StoreProblem
from libre_tpu_torch.train.trainer import InverseRenderProblem


def atlas_from_jax(flat: np.ndarray, brick_shape_zyx) -> np.ndarray:
    """(n_slots, voxels_padded) flat atlas → (n_slots, BZ, BY, BX)."""
    flat = np.asarray(flat)
    voxels = int(np.prod(brick_shape_zyx))
    return np.array(flat[:, :voxels]).reshape(
        (flat.shape[0],) + tuple(brick_shape_zyx)
    )


def store_from_jax(store: np.ndarray, fine_dims: Tuple[int, int, int]) -> np.ndarray:
    """(Na_store, Nc_pad, Nb_pad) store → (Na, Nc, Nb)."""
    na, nc, nb = fine_dims
    return np.array(np.asarray(store)[:na, :nc, :nb])


def assembly_plan_from_jax(plan) -> swb.AssemblyPlan:
    """The JAX package's ``AssemblyPlan`` → the port's (same fields)."""
    return swb.AssemblyPlan(
        axis=plan.axis,
        render_level=plan.render_level,
        fine_dims=tuple(plan.fine_dims),
        block=tuple(plan.block),
        padded_zyx=tuple(plan.padded_zyx),
        overlap=tuple(plan.overlap),
        levels=tuple(
            swb.LevelTables(
                level=lt.level,
                factor=lt.factor,
                slots=np.asarray(lt.slots),
                resident=np.asarray(lt.resident),
                own=np.asarray(lt.own),
                dims=tuple(lt.dims),
            )
            for lt in plan.levels
        ),
        lo=plan.lo,
        hi=plan.hi,
    )


def store_grad_from_jax(d_store: np.ndarray, fine_dims: Tuple[int, int, int]) -> np.ndarray:
    """(Na_store, Nc_pad, Nb_pad) density-store gradient → (Na, Nc, Nb).
    Raises if the padding holds gradient: none may flow there."""
    na, nc, nb = fine_dims
    padding = np.array(np.asarray(d_store))
    padding[:na, :nc, :nb] = 0.0
    if padding.any():
        raise ValueError("store_grad_from_jax: gradient in the store's padding")
    return store_from_jax(d_store, fine_dims)


def params_from_jax(params: Dict, fine_dims: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
    """{"store": padded store, "tf": (256, 4)} → the same, unpadded."""
    return {
        "store": store_from_jax(params["store"], fine_dims),
        "tf": np.array(np.asarray(params["tf"])),
    }


def classified_from_jax(chans: np.ndarray, nc: int, nb: int) -> np.ndarray:
    """(Na, 4·Nc_pad, Nb_pad) classified plane stack → (Na, Nc, Nb, 4).
    Raises if the padding holds a nonzero value."""
    chans = np.asarray(chans)
    na, rows, nb_pad = chans.shape
    planes = chans.reshape(na, 4, rows // 4, nb_pad)
    padding = np.array(planes)
    padding[:, :, :nc, :nb] = 0.0
    if padding.any():
        raise ValueError("classified_from_jax: nonzero values in the stack's padding")
    return np.ascontiguousarray(np.moveaxis(planes[:, :, :nc, :nb], 1, -1))


def exact_params_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """{"density": (Z, Y, X), "tf": (256, 4)} of the JAX package's exact
    ``TrainState.params`` → numpy copies (no padding to strip)."""
    return {k: np.array(np.asarray(params[k]), np.float32) for k in ("density", "tf")}


def store_problem_from_jax(problem) -> StoreProblem:
    """The JAX package's ``StoreProblem`` → the port's (its TPU chunking
    and interpret-mode fields dropped)."""
    return StoreProblem(
        views=np.array(np.asarray(problem.views), np.float32),
        na_store=problem.na_store,
        na_real=problem.na_real,
        nc_real=problem.nc_real,
        nb_real=problem.nb_real,
        k_planes=problem.k_planes,
        inter_size=tuple(problem.inter_size),
        world_min=np.asarray(problem.world_min, np.float32),
        world_max=np.asarray(problem.world_max, np.float32),
        axis=problem.axis,
        diff_tf=problem.diff_tf,
    )


def render_params_from_jax(params) -> RenderParams:
    """The JAX package's ``RenderParams`` → the port's (its ``remat``,
    an XLA rematerialisation switch, dropped)."""
    return RenderParams(**{
        f.name: getattr(params, f.name) for f in dataclasses.fields(RenderParams)
    })


def shearwarp_problem_from_jax(problem) -> ShearWarpProblem:
    """The JAX package's ``ShearWarpProblem`` → the port's: the per-view
    plans (numpy copies), the world box and the params."""
    swp = problem.swp
    return ShearWarpProblem(
        plans=tuple(
            sw.ShearWarpPlan(
                axis=int(p.axis),
                sign=float(p.sign),
                bounds=tuple(float(b) for b in p.bounds),
                eye=np.array(np.asarray(p.eye), np.float32),
                u=np.array(np.asarray(p.u), np.float32),
                v=np.array(np.asarray(p.v), np.float32),
                valid=np.array(np.asarray(p.valid)),
            )
            for p in problem.plans
        ),
        world_min=np.array(np.asarray(problem.world_min), np.float32),
        world_max=np.array(np.asarray(problem.world_max), np.float32),
        params=render_params_from_jax(problem.params),
        swp=sw.ShearWarpParams(
            n_planes=swp.n_planes,
            inter_size=tuple(swp.inter_size),
            slope_margin=swp.slope_margin,
            classification=swp.classification,
            compute_dtype=swp.compute_dtype,
        ),
    )


def scene_params_from_jax(params: Dict) -> Dict[str, np.ndarray]:
    """{"density": (N, BZ, BY, BX), "tf": (T, 4)} of the JAX package's
    ``VolumeScene.parameters`` → the port's, the same shapes, numpy
    copies."""
    density = np.asarray(params["density"], np.float32)
    if density.ndim != 4:
        raise ValueError(
            f"scene_params_from_jax: needs an (N, BZ, BY, BX) brick stack, got {density.shape}"
        )
    return {"density": np.array(density), "tf": np.array(np.asarray(params["tf"]), np.float32)}


def brick_set_from_jax(bricks, device="cuda") -> BrickSet:
    """The JAX package's ``BrickSet`` → the port's, f32 tensors on
    ``device``."""
    return BrickSet(*(
        torch.from_numpy(np.array(np.asarray(x), np.float32)).to(device) for x in bricks
    ))


def inverse_render_problem_from_jax(problem, width=None, device="cuda") -> InverseRenderProblem:
    """The JAX package's ``InverseRenderProblem`` → the port's, its brick
    set on ``device``; its XLA ``chunk`` dropped, ``width`` the screen width
    the port's kernels tile each shard's rays by."""
    return InverseRenderProblem(
        bricks=brick_set_from_jax(problem.bricks, device),
        global_min=np.asarray(problem.global_min, np.float32),
        global_max=np.asarray(problem.global_max, np.float32),
        params=render_params_from_jax(problem.params),
        max_steps=int(problem.max_steps),
        width=width,
    )


def train_params_from_jax(params: Dict, mesh: Mesh) -> Dict:
    """The JAX mesh-sharded trainer's ``TrainState.params``, a density
    sharded on the brick axis, (N, BZ, BY, BX), and the (T, 4) TF → the
    port's layout over ``mesh``: brick shard kd's chunk on
    ``mesh.device(0, kd)`` and the TF on ``mesh.lead`` (f32 copies, as
    ``train.trainer.init_state`` places its leaves)."""
    density = np.asarray(params["density"], np.float32)
    d_k = mesh.shape[BRICK_AXIS]
    if density.ndim != 4 or density.shape[0] % d_k:
        raise ValueError(
            f"train_params_from_jax: {density.shape} density over {d_k} brick shards"
        )
    b_l = density.shape[0] // d_k
    return {
        "density": [torch.from_numpy(np.array(density[kd * b_l:(kd + 1) * b_l]))
                    .to(mesh.device(0, kd)) for kd in range(d_k)],
        "tf": torch.from_numpy(np.array(np.asarray(params["tf"]), np.float32)).to(mesh.lead),
    }


def store_slabs_from_jax(
    slabs: np.ndarray, a_base, fine_dims: Tuple[int, int, int]
) -> Tuple[List[np.ndarray], np.ndarray]:
    """The JAX package's slab-sharded store, (d_k, Na_slab, Nc_pad, Nb_pad)
    lane-padded slabs (``shard_store_slabs_uniform`` or
    ``build_sharded_slabs``) with their first global slices ``a_base``
    (d_k,) → (the port's per-shard list of unpadded (slices, Nc, Nb)
    slabs, a_base as int32).  A slab keeps its slices up to the store's
    last one; its lane padding is stripped."""
    slabs = np.asarray(slabs)
    a_base = np.asarray(a_base, np.int32).reshape(-1)
    if slabs.ndim != 4 or slabs.shape[0] != a_base.shape[0]:
        raise ValueError(
            f"store_slabs_from_jax: {slabs.shape} slabs for {a_base.shape[0]} offsets"
        )
    na, nc, nb = fine_dims
    out = [
        np.array(slabs[d, : max(0, na - int(a_base[d])), :nc, :nb])
        for d in range(slabs.shape[0])
    ]
    return out, a_base


def mesh_from_jax(mesh, device="cuda") -> Mesh:
    """A JAX ``Mesh`` with axes (ray, brick) → a port :class:`Mesh` of
    the same shape whose every shard is ``device``."""
    n_ray, n_brick = int(mesh.shape[RAY_AXIS]), int(mesh.shape[BRICK_AXIS])
    return make_mesh(n_brick=n_brick, n_ray=n_ray, devices=[device] * (n_ray * n_brick))
