"""State carried across from the JAX package, as numpy arrays.

The JAX package lays its device state out for the TPU: the brick atlas
is flat slots padded to 128 lanes, and the assembled store pads its two
in-plane axes to multiples of 128.  These functions strip that padding
so the port and the JAX package can be fed the same state; the (256, 4)
transfer function needs no conversion.  Results are writable copies, so
``torch.from_numpy`` can take them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from libre_tpu_torch.ops import shearwarp_bricked as swb


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
