"""What the drivers share: the program's camera type, the readings of a
``torch.optim`` trainer, the set-up's phases and the window's jobs on the
host clock, freeing the card."""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Tuple

import torch


def program_camera(cam: Dict):
    from libre_tpu_torch.ops.reference import Camera

    return Camera(inv_proj=cam["inv_proj"], inv_mv=cam["inv_mv"], viewport=cam["viewport"],
                  near=cam["near"])


def first_grad_norms(optimizer: torch.optim.Optimizer, leaves: Dict[str, torch.Tensor]):
    """Each leaf's first gradient as the optimizer got it, from its state
    after one step: Adam's first moment is then (1 − β1)·g (0 for a leaf
    the optimizer holds no moment of: it got no gradient)."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    out = {}
    for k, p in leaves.items():
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(
            torch.linalg.vector_norm(m, dtype=torch.float64)) / (1.0 - beta1)
    return out


def norms_of_change(leaves: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]):
    return {k: float(torch.linalg.vector_norm(leaves[k].detach() - start[k], dtype=torch.float64))
            for k in leaves}


def free_device():
    """Free what deleted objects held (reference cycles first)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Phases:
    """The set-up's phases on the host clock, each ended by a
    synchronise: ``mark(name)`` closes the phase begun at the last mark."""

    def __init__(self):
        self.done: List[Tuple[str, float]] = []
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.done.append((name, now - self.t))
        self.t = now


class Jobs:
    """A training window as whole jobs of ``steps`` steps, each from the
    same start: ``position()`` is the step's place in its job (0 restarts
    the job), and the host clock at every restart times the jobs."""

    def __init__(self, steps: int, first: int):
        self.steps, self.next, self.marks = steps, first, []

    def position(self) -> int:
        j = self.next % self.steps
        if j == 0:
            self.marks.append(time.perf_counter())
        self.next += 1
        return j

    def ms_per_step(self) -> List[float]:
        """Each whole job's milliseconds a step (the loss read of each
        step synchronises)."""
        return [(b - a) * 1e3 / self.steps for a, b in zip(self.marks, self.marks[1:])]


def restart_optimizer(optimizer: torch.optim.Optimizer, params: Dict[str, torch.Tensor],
                      start: Dict[str, torch.Tensor]) -> None:
    """The parameters back to ``start`` and the optimizer's state to what
    it was before its first step (none)."""
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(start[k])
    optimizer.state.clear()
