"""The numbers that decide ``correct``, each against its limit.

Training: each step's loss as a share of the reference's; per leaf the
gap between the program's and the reference's norm of the first
gradient, and of the change over the checked steps, over the larger of
the reference's norm of that leaf and of the median leaf.  A leaf whose
reference gradient is under a thousandth of the median leaf's is left
out of the change: Adam moves such a leaf by round-off alone.  With two
leaves of unlike scale (the store's gradient and the TF's) the median
judges the smaller at the larger's scale, and Adam's update hides a
gradient scaled as a whole; so each other leaf's first gradient is also
judged against its own reference norm (``leaf_grad_gap``).

Frames: per sampled frame the largest and the mean absolute gap of a
pixel channel from the reference's frame of the same pose."""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict

QUIET_LEAF = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    med = statistics.median(ref[k] for k in ref)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]
    return max(gaps) if gaps else 0.0


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{"loss_gap", "grad_gap", "leaf_grad_gap", "step_gap"} of the
    program's readings against the reference's (``reference.train``'s
    keys)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= QUIET_LEAF * med]
    own = [abs(prog["grad_norms"][k] - g_ref[k]) / g_ref[k] for k in moving if g_ref[k] > 0]
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap(prog["grad_norms"], g_ref, list(g_ref)),
        "leaf_grad_gap": max(own) if own else float("inf"),
        "step_gap": _leaf_gap(prog["change_norms"], ref["change_norms"], moving),
    }


def frame_numbers(frames, ref_frames) -> Dict[str, float]:
    """{"frame_max_gap", "frame_mean_gap"} over the sampled frames."""
    worst_max = worst_mean = 0.0
    for got, want in zip(frames, ref_frames):
        gap = (got.reshape(-1, 4).float() - want.reshape(-1, 4)).abs()
        worst_max = max(worst_max, float(gap.max()))
        worst_mean = max(worst_mean, float(gap.mean()))
    if len(frames) != len(ref_frames) or not frames:
        return {"frame_max_gap": float("inf"), "frame_mean_gap": float("inf")}
    return {"frame_max_gap": worst_max, "frame_mean_gap": worst_mean}


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    return json.loads((root / "perfbench" / "limits" / f"{workload}.json").read_text())["limits"]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is finite and within its limit (a number
    without a limit fails: the limits file names every number)."""
    return all(
        k in limits and math.isfinite(v) and v <= limits[k]
        for k, v in numbers.items()
    )
