"""Inverse-rendering training (``libre_tpu.train``): optimize voxel
densities and the transfer function from target images, through the
differentiable store core (``store_trainer``: ``fit``), the exact
marcher over a mesh-sharded brick set (``trainer``:
``InverseRenderProblem``, ``init_state``, ``make_train_step``) or over one
brick (``init_exact_state``, ``make_exact_train_step``), or a dense grid
through the plain shear-warp pipeline (``shearwarp_trainer``:
``ShearWarpProblem``, ``fit_shearwarp``).  The store and dense trainers
also run over a (ray × brick) mesh (``mesh=``), and the store trainer
with its store sharded in slabs (``make_slab_train_step``)."""

from libre_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from libre_tpu_torch.train.shearwarp_trainer import (
    ShearWarpProblem,
    fit as fit_shearwarp,
    make_train_step as make_shearwarp_train_step,
)
from libre_tpu_torch.train.store_trainer import (
    StoreProblem,
    fit,
    make_slab_train_step,
    make_train_step as make_store_train_step,
)
from libre_tpu_torch.train.trainer import (
    InverseRenderProblem,
    TrainState,
    init_exact_state,
    init_state,
    make_exact_train_step,
    make_train_step,
)

__all__ = [
    "ShearWarpProblem",
    "make_shearwarp_train_step",
    "fit_shearwarp",
    "StoreProblem",
    "make_store_train_step",
    "make_slab_train_step",
    "fit",
    "InverseRenderProblem",
    "init_state",
    "make_train_step",
    "TrainState",
    "init_exact_state",
    "make_exact_train_step",
    "save_checkpoint",
    "restore_checkpoint",
]
