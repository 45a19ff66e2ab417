"""Checkpoint and resume for inverse rendering
(``libre_tpu.train.checkpoint``): the parameters and, if given, the
optimizer's state, written with ``torch.save`` to one file."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(
    path: str,
    params: Dict[str, torch.Tensor],
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> None:
    """Save ``params`` (host copies) and the optimizer's ``state_dict``
    to the file ``path``; the write goes to a temporary file renamed into
    place, so a crash never leaves a half-written checkpoint."""
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "optimizer": None if optimizer is None else optimizer.state_dict(),
    }
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(
    path: str,
    optimizer: Optional[torch.optim.Optimizer] = None,
    device="cuda",
) -> Dict[str, torch.Tensor]:
    """Load the params saved at ``path`` onto ``device`` (the card unless
    the caller asks for the CPU); if
    ``optimizer`` is given, load the saved optimizer state into it (it
    must have been built over the restored params' shapes)."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path}: checkpoint holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    return {k: v.to(device) for k, v in state["params"].items()}
