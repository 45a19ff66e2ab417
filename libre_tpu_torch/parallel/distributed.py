"""Multi-process bootstrap, replicated-state broadcast and the collectives of
a process-spanning mesh (``libre_tpu.parallel.distributed``).

The reference's Equalizer/Collage process lifecycle (SURVEY.md §5.8:
the server launches render clients, Client.cpp:260-277) becomes
``torch.distributed``: :func:`initialize` joins a process group over a
``tcp://`` rendezvous that the caller names (nothing on the machine
announces a cluster); the versioned FrameData commit/sync (Config.cpp:346,
Node.cpp:79-83) becomes :func:`broadcast_frame_state`, a pickled broadcast
from the controller (rank 0) before each frame; frame sync points become
:func:`sync_global_devices`, a barrier.

A mesh that spans processes puts the RAY axis across them: sort-first
needs no communication but the final gather of each process's rows
(:func:`gather_rows`), and a training step sums its loss and replicated
gradients across processes (:func:`all_reduce_sum`).  The brick axis
stays inside each process (``parallel/mesh.py``), where its per-frame
compositing traffic is device to device.

The backend is the caller's: ``gloo`` for CPU tensors and pickled state,
``nccl`` where each rank owns a card (NCCL refuses two ranks on one
GPU).  Under ``gloo`` a CUDA tensor that crosses processes is copied to
the host and back here, explicitly.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvous at ``coordinator_address`` ("host:port");
    a no-op for one process or none."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize: a multi-process group needs its address and this rank")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_controller() -> bool:
    """True on the process that mutates settings (the reference's app
    node; rank 0 here)."""
    return process_index() == 0


def broadcast_frame_state(tree: Any, src: int = 0) -> Any:
    """A small picklable settings object from rank ``src`` to every
    process — the FrameData commit/sync cycle (FrameData.h:32-147) without
    Collage.  Other ranks' ``tree`` is ignored."""
    if process_count() == 1:
        return tree
    box = [tree if process_index() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def sync_global_devices(tag: str) -> None:
    """Barrier across processes (frame lifecycle sync points); ``tag``
    names the point, as the JAX package's does."""
    del tag
    if process_count() > 1:
        dist.barrier()


def _host_if_gloo(x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if dist.get_backend() == "gloo" else x


def process_rows(v_size: int) -> slice:
    """This process's block of the ray axis: rows [r·V/P, (r+1)·V/P) of a
    V-row grid, P processes, rank r."""
    p, r = process_count(), process_index()
    if v_size % p:
        raise ValueError(f"V={v_size} rows must divide {p} processes")
    step = v_size // p
    return slice(r * step, (r + 1) * step)


def gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every process's row block (equal shapes), concatenated along dim 0
    in rank order, on ``local``'s device."""
    if process_count() == 1:
        return local
    x = _host_if_gloo(local.contiguous())
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=0).to(local.device)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over processes, as a new tensor on ``x``'s device."""
    if process_count() == 1:
        return x.clone()
    y = _host_if_gloo(x.detach()).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y.to(x.device)
