"""Inverse-rendering training (``libre_tpu.train``): optimize voxel
densities and the transfer function from target images through the
differentiable store core.  The exact-marcher trainer
(``InverseRenderProblem``/``TrainState``) is ROADMAP M7."""

from libre_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from libre_tpu_torch.train.store_trainer import (
    StoreProblem,
    fit,
    make_train_step as make_store_train_step,
)

__all__ = [
    "StoreProblem",
    "make_store_train_step",
    "fit",
    "save_checkpoint",
    "restore_checkpoint",
]
