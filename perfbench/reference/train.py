"""The trainers' first steps in plain PyTorch, and the readings the
benchmark compares: each step's loss, the first gradient's norm per
leaf, and each leaf's change after the steps.

The update is Adam as Kingma and Ba give it (m ← m + (1 − β1)(g − m),
v ← β2·v + (1 − β2)·g², p ← p − (lr / (1 − β1^t))·m / (√v / √(1 − β2^t) +
ε)); the store trainer then clamps the store to [0, 1] where it was
covered before the update and pins the rest at the sentinel, both
trainers clamp the TF to [0, 1]."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench.reference import exact, shearwarp
from perfbench.reference.sinks import Sinks

SENTINEL = -1024.0


class Adam:
    def __init__(self, leaves: Dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.v = {k: torch.zeros_like(v) for k, v in leaves.items()}

    def step(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2_sqrt = math.sqrt(1.0 - self.b2 ** self.t)
        for k, p in leaves.items():
            g = grads[k]
            self.m[k] += (1.0 - self.b1) * (g - self.m[k])
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            p -= (self.lr / bc1) * self.m[k] / (self.v[k].sqrt() / bc2_sqrt + self.eps)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v, dtype=torch.float64)) for k, v in d.items()}


def store_fit(truth, tf0, views: List, geom: Dict, lr: float, steps: int, *,
              diff_tf: bool, vdt=torch.float32, keep: Optional[int] = None) -> Dict:
    """``steps`` steps of the store trainer from the flat 0.5 start over
    ``truth``'s coverage, against the targets this reference renders of
    ``truth``; ``views`` are the (11,) view vectors, ``geom`` the store's
    (shape, k_planes, inter_size, wb, wc).  ``keep`` trains on the first
    ``keep`` views only (the half-batch fault)."""
    dev = truth.device
    shape = tuple(truth.shape)
    k_planes = geom["k_planes"]
    v_size, u_size = geom["inter_size"]
    window = {"wb": geom["wb"], "wc": geom["wc"]}
    tabs = [shearwarp.tables(torch.as_tensor(vs, device=dev), shape[0], k_planes, v_size, u_size)
            for vs in views]
    if keep is not None:
        tabs = tabs[:keep]
    truth_flat = truth.reshape(-1).to(vdt)
    with torch.no_grad():
        targets = [shearwarp.render(truth_flat, shape, tf0.to(vdt), t, window, vdt=vdt)
                   for t in tabs]
    del truth_flat
    leaves = {"store": torch.where(truth > -0.5, 0.5, SENTINEL).to(torch.float32),
              "tf": tf0.clone()}
    start = {k: v.clone() for k, v in leaves.items()}
    adam = Adam(leaves, lr)
    denom = float(len(tabs) * v_size * u_size * 4)
    losses, first = [], None
    for _ in range(steps):
        sinks = Sinks(truth.numel(), tf0.shape[0], dev)
        flat = leaves["store"].reshape(-1).to(vdt)
        tf = leaves["tf"].to(vdt)
        total = 0.0
        for tab, target in zip(tabs, targets):
            out = shearwarp.render(flat, shape, tf, tab, window, sinks=sinks, vdt=vdt)
            se = torch.sum((out - target) ** 2) / denom
            se.backward()
            total += float(se.detach())
        del flat, tf
        grads = {"store": sinks.volume.reshape(shape),
                 "tf": sinks.tf.float() if diff_tf else torch.zeros_like(leaves["tf"])}
        losses.append(total)
        if first is None:
            first = _norms(grads)
        with torch.no_grad():
            covered = leaves["store"] > -0.5
            adam.step(leaves, grads)
            leaves["store"].copy_(torch.where(covered, leaves["store"].clamp(0.0, 1.0), SENTINEL))
            leaves["tf"].clamp_(0.0, 1.0)
        del sinks, grads
    return {"losses": losses, "grad_norms": first,
            "change_norms": _norms({k: leaves[k] - start[k] for k in leaves})}


def exact_fit(truth, tf0, rays_by_pose: List[Dict], render_cfg: Dict, lr: float, steps: int, *,
              block: int, vdt=torch.float32, keep_half: bool = False) -> Dict:
    """``steps`` steps of the exact trainer from a flat 0.5 density, step
    s on pose s − 1, against the targets this reference renders of
    ``truth``.  ``keep_half`` trains on the first half of each view's
    rays (the half-batch fault)."""
    dev = truth.device
    used = rays_by_pose[:steps]
    with torch.no_grad():
        targets = [exact.render(truth, tf0, r, render_cfg, block=block, vdt=vdt) for r in used]
    leaves = {"density": torch.full_like(truth, 0.5), "tf": tf0.clone()}
    start = {k: v.clone() for k, v in leaves.items()}
    adam = Adam(leaves, lr)
    losses, first = [], None
    for rays, target in zip(used, targets):
        n_rays = rays["dirs"].shape[0]
        sinks = Sinks(truth.numel(), tf0.shape[0], dev)
        keep = slice(0, n_rays // 2) if keep_half else None
        losses.append(exact.loss_and_grads(leaves["density"], leaves["tf"], rays, target,
                                           render_cfg, sinks, block=block, vdt=vdt, keep=keep))
        grads = {"density": sinks.volume.reshape(truth.shape), "tf": sinks.tf.float()}
        if first is None:
            first = _norms(grads)
        with torch.no_grad():
            adam.step(leaves, grads)
            leaves["tf"].clamp_(0.0, 1.0)
        del sinks, grads
    return {"losses": losses, "grad_norms": first,
            "change_norms": _norms({k: leaves[k] - start[k] for k in leaves})}
