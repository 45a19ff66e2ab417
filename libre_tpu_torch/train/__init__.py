"""Inverse-rendering training (``libre_tpu.train``): optimize voxel
densities and the transfer function from target images, through the
differentiable store core (``store_trainer``: ``fit``) or the exact
marcher (``trainer``: ``init_exact_state``, ``make_exact_train_step``).
The sharded trainers are ROADMAP M9."""

from libre_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from libre_tpu_torch.train.store_trainer import (
    StoreProblem,
    fit,
    make_train_step as make_store_train_step,
)
from libre_tpu_torch.train.trainer import (
    TrainState,
    init_exact_state,
    make_exact_train_step,
)

__all__ = [
    "StoreProblem",
    "make_store_train_step",
    "fit",
    "TrainState",
    "init_exact_state",
    "make_exact_train_step",
    "save_checkpoint",
    "restore_checkpoint",
]
