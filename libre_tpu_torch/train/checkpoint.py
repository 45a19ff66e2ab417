"""Checkpoint and resume for inverse rendering
(``libre_tpu.train.checkpoint``): the parameters and, if given, the
optimizer's state, written with ``torch.save`` to one file.  A parameter
may be a list of tensors, as the mesh-sharded exact trainer's per-shard
density leaves are."""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def save_checkpoint(
    path: str,
    params: Dict,
    optimizer: Optional[torch.optim.Optimizer] = None,
) -> None:
    """Save ``params`` (host copies; a list-valued parameter as a list)
    and the optimizer's ``state_dict`` to the file ``path``; the write
    goes to a temporary file renamed into place, so a crash never leaves a
    half-written checkpoint."""

    def host(v):
        return [t.detach().cpu() for t in v] if isinstance(v, (list, tuple)) else v.detach().cpu()

    state = {
        "params": {k: host(v) for k, v in params.items()},
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
) -> Dict:
    """Load the params saved at ``path`` onto ``device`` (the card unless
    the caller asks for the CPU): one device for every tensor, or a
    sequence of devices, entry i of a list-valued parameter on the i-th
    and every other parameter on the first (a mesh's brick-shard devices,
    the lead first).  If ``optimizer`` is given, load the saved optimizer
    state into it (it must have been built over the restored params'
    shapes)."""
    state = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if optimizer is not None:
        if state["optimizer"] is None:
            raise ValueError(f"{path}: checkpoint holds no optimizer state")
        optimizer.load_state_dict(state["optimizer"])
    devices = [device] if isinstance(device, (str, torch.device)) else list(device)

    def place(v):
        if isinstance(v, list):
            return [t.to(devices[i if len(devices) > 1 else 0]) for i, t in enumerate(v)]
        return v.to(devices[0])

    return {k: place(v) for k, v in state["params"].items()}
