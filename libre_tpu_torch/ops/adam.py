"""One step of Adam over one leaf, with the leaf's epilogue fused in.

The trainers' update (``train/update.py``) runs ``torch.optim.Adam``'s
arithmetic through this wrapper for every leaf of a plain Adam on the
card: ``csrc/adam_update.cu``, one streaming pass that reads the
parameter, its gradient and the two moments once and writes the
parameter and the moments once (28 B a value), with the epilogue the
trainer states for the leaf applied on the way out:

* ``"none"``: the exact trainer's density;
* ``"clamp01"``: the parameter clamped to [0, 1] (every TF, the dense
  trainer's volume);
* ``"pin"``: the store trainer's store, clamped to [0, 1] where its value
  before the update is > -0.5 (covered) and set to ``SENTINEL`` elsewhere.

The wrapper checks dtype, shape, device, contiguity and alignment and
raises on what the kernel does not take; on CPU tensors it runs its plain
version (``adam_update.reference``), on CUDA tensors it launches the
kernel on the current stream and adds one to ``adam_update.launches``.
Both update in place.  The plain version is torch's single-tensor Adam
op for op, so on the CPU it is bit for bit ``torch.optim.Adam`` followed
by the epilogue; the kernel computes the same f32 operations in the same
order with no contraction (``--fmad=false``), and torch's own CUDA
kernels contract, so on the card the two agree to a few ulp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels
from .shearwarp_bricked import SENTINEL

EPILOGUES = ("none", "clamp01", "pin")
_CHUNK = 2**30  # values a launch takes: the kernel counts them in an int


def apply_epilogue(p: torch.Tensor, epilogue: str, covered=None) -> None:
    """``epilogue`` on ``p`` in place by torch's ops; the pin's coverage is
    ``covered``, or ``p > -0.5`` as ``p`` stands."""
    if epilogue == "pin":
        covered = p > -0.5 if covered is None else covered
        p.copy_(torch.where(covered, p.clamp(0.0, 1.0), SENTINEL))
    elif epilogue == "clamp01":
        p.clamp_(0.0, 1.0)


def adam_update_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
    step: float, lr: float, betas: Tuple[float, float], eps: float, epilogue: str = "none",
) -> None:
    """Plain PyTorch: Adam's step ``step`` (1 for the first) of ``p`` from
    its gradient ``g`` and moments ``m``, ``v``, in place, as
    ``torch.optim.Adam``'s single-tensor step computes it, then the
    epilogue (the pin's coverage from ``p`` before the update)."""
    beta1, beta2 = betas
    covered = p > -0.5 if epilogue == "pin" else None
    m.lerp_(g, 1 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
    step_size = lr / (1 - beta1**step)
    bc2_sqrt = (1 - beta2**step) ** 0.5
    p.addcdiv_(m, (v.sqrt() / bc2_sqrt).add_(eps), value=-step_size)
    apply_epilogue(p, epilogue, covered)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"adam_update: {msg}")


def adam_update(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
    step: float, lr: float, betas: Tuple[float, float], eps: float, epilogue: str = "none",
) -> None:
    """:func:`adam_update_reference` by ``csrc/adam_update.cu`` on CUDA
    tensors: four f32 tensors of one shape on one device, contiguous and
    16 B aligned on the card; one launch per 2**30 values."""
    _check(epilogue in EPILOGUES, f"epilogue {epilogue!r} not in {EPILOGUES}")
    for t in (p, g, m, v):
        _check(t.dtype == torch.float32, f"expected float32, got {t.dtype}")
        _check(t.layout == torch.strided and t.is_contiguous(), "operands must be contiguous")
        _check(t.device == p.device, f"operands on {t.device} and {p.device}")
        _check(t.shape == p.shape, f"shapes {tuple(t.shape)} and {tuple(p.shape)}")
    _check(p.device.type in ("cpu", "cuda"), f"no kernel for device {p.device}")
    if p.device.type == "cpu":
        adam_update_reference(p, g, m, v, step=step, lr=lr, betas=betas, eps=eps,
                              epilogue=epilogue)
        return
    for t in (p, g, m, v):
        _check(t.data_ptr() % 16 == 0, "operands must be 16 B aligned")
    beta1, beta2 = betas
    scalars = (
        float(1 - beta1), float(beta2), float(1 - beta2),
        float(-(lr / (1 - beta1**step))), float((1 - beta2**step) ** 0.5), float(eps),
        float(SENTINEL),
    )
    code = EPILOGUES.index(epilogue)
    n = p.numel()
    with torch.cuda.device(p.device):
        for a in range(0, n, _CHUNK):
            off = 4 * a
            _kernels.launch(
                "adam_update", p.data_ptr() + off, g.data_ptr() + off, m.data_ptr() + off,
                v.data_ptr() + off, min(_CHUNK, n - a), code, *scalars,
            )
            adam_update.launches += 1


adam_update.launches = 0
adam_update.reference = adam_update_reference
