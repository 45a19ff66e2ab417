"""State carried across from the JAX package, as numpy arrays.

The JAX package lays its device state out for the TPU: the brick atlas
is flat slots padded to 128 lanes, and the assembled store pads its two
in-plane axes to multiples of 128.  These functions strip that padding
so the port and the JAX package can be fed the same state; the (256, 4)
transfer function and the exact trainer's (Z, Y, X) density need no
conversion.  Results are writable copies, so
``torch.from_numpy`` can take them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.train.store_trainer import StoreProblem


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
