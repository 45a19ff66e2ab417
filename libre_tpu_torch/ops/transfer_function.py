"""1-D RGBA transfer functions: lookup, defaults, file IO
(``libre_tpu.ops.transfer_function``).

The defaults and the .1dt file IO are numpy copies of the JAX package's;
``lookup`` is the GL linear-filtered, clamp-to-edge 1-D texture fetch of
GLRaycastRenderer.cpp:175-193: on CUDA tensors one pass of
``csrc/tf_lookup.cu`` forward and one backward, on the CPU its plain
version ``lookup_reference`` in torch.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.utils.profiling import span

TF_SIZE = 256


def default_color_map(size: int = TF_SIZE) -> np.ndarray:
    """A smooth default colormap (hue ramp + linear alpha ramp), (size, 4)
    float32 in [0, 1]."""
    x = np.linspace(0.0, 1.0, size, dtype=np.float32)
    r = np.clip(1.5 * x - 0.25, 0, 1)
    g = np.clip(1.5 * np.abs(x - 0.5) * -1 + 1.0, 0, 1) * x
    b = np.clip(1.0 - 1.5 * x, 0, 1) + 0.2 * x
    a = x
    return np.stack([r, g, np.clip(b, 0, 1), a], axis=-1).astype(np.float32)


def grayscale_ramp(size: int = TF_SIZE) -> np.ndarray:
    x = np.linspace(0.0, 1.0, size, dtype=np.float32)
    return np.stack([x, x, x, x], axis=-1).astype(np.float32)


class _TakeRows(torch.autograd.Function):
    """``table[idx]`` for a small (N, C) table and many indices, with a
    backward that sums the cotangent's rows per index by ``torch.bincount``:
    :func:`lookup_reference`'s two gathers.  Autograd's own
    backward of ``table[idx]`` sorts the indices and adds each index's rows
    one after another: over a dense trainer's 16.7M samples in 256 TF texels
    it took 1.9 s a call on an H100 (``chip_smoke.py`` phase 21).  The
    gather runs under the span ``libre.tf.take_rows``, its backward under
    ``libre.tf.take_rows.backward``."""

    @staticmethod
    def forward(ctx, table, idx):
        with span("libre.tf.take_rows"):
            ctx.save_for_backward(idx)
            ctx.n_rows = table.shape[0]
            return table.index_select(0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])

    @staticmethod
    def backward(ctx, g):
        with span("libre.tf.take_rows.backward"):
            (idx,) = ctx.saved_tensors
            flat = idx.reshape(-1)
            g = g.reshape(flat.numel(), -1)
            cols = [torch.bincount(flat, weights=g[:, c], minlength=ctx.n_rows)
                    for c in range(g.shape[1])]
            return torch.stack(cols, dim=1).to(g.dtype), None


def lookup_reference(tf: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """GL linear-filtered, clamp-to-edge 1-D texture lookup in plain torch:
    :func:`lookup`'s CPU path and the specification of its kernel.

    ``tf``: (N, 4); ``density``: any shape, nominally in [0, 1].  Texel i
    is centered at (i + 0.5)/N; coordinates outside clamp to the edge
    texels.  Returns ``density.shape + (4,)``.
    """
    n = tf.shape[0]
    s = torch.clamp(density, 0.0, 1.0) * n - 0.5
    s = torch.clamp(s, 0.0, float(n - 1))
    i0f = torch.floor(s)
    w = (s - i0f)[..., None]
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return _TakeRows.apply(tf, i0) * (1.0 - w) + _TakeRows.apply(tf, i1) * w


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., 4) contiguous and 16 B aligned: the kernel's float4 rows."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _Lookup(torch.autograd.Function):
    """:func:`lookup_reference` by ``csrc/tf_lookup.cu``: the forward one pass
    under the span ``libre.tf.take_rows``, the backward one pass under
    ``libre.tf.take_rows.backward`` (autograd's thread on the card) that
    recomputes the taps from the saved density and writes only the
    gradients autograd asks for.  Each launch adds one to
    ``lookup.launches``."""

    @staticmethod
    def forward(ctx, tf, density):
        with span("libre.tf.take_rows"):
            table, dens = _rows(tf), density.contiguous()
            out = torch.empty(density.shape + (4,), dtype=torch.float32, device=density.device)
            if dens.numel():
                with torch.cuda.device(dens.device):
                    _kernels.launch("tf_lookup", dens, table, None, out, None, None,
                                    dens.numel(), table.shape[0])
                lookup.launches += 1
            ctx.save_for_backward(table, dens)
            return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        with span("libre.tf.take_rows.backward"):
            want_tf, want_density = ctx.needs_input_grad
            table, dens = ctx.saved_tensors
            d_tf = torch.zeros_like(table) if want_tf else None
            d_density = torch.empty_like(dens) if want_density else None
            if (want_tf or want_density) and dens.numel():
                with torch.cuda.device(dens.device):
                    _kernels.launch("tf_lookup", dens, table, _rows(g), None, d_density,
                                    d_tf, dens.numel(), table.shape[0])
                lookup.launches += 1
            return d_tf, d_density


def lookup(tf: torch.Tensor, density: torch.Tensor) -> torch.Tensor:
    """GL linear-filtered, clamp-to-edge 1-D texture lookup
    (:func:`lookup_reference`), differentiable in both arguments.

    ``tf``: (N, 4); ``density``: any shape.  On a CUDA density this launches
    ``csrc/tf_lookup.cu`` (``lookup.launches`` counts its forward and
    backward launches): float32 ``tf`` and ``density`` on one device, any
    N ≥ 1, bit-equal to the plain version's forward; anything else raises.
    Any other density takes :func:`lookup_reference`.
    """
    if density.device.type != "cuda":
        return lookup_reference(tf, density)
    for name, t in (("tf", tf), ("density", density)):
        if t.dtype != torch.float32:
            raise TypeError(f"lookup: {name} must be float32, got {t.dtype}")
    if tf.device != density.device:
        raise ValueError(f"lookup: tf on {tf.device}, density on {density.device}")
    if tf.dim() != 2 or tf.shape[1] != 4 or tf.shape[0] < 1:
        raise ValueError(f"lookup: tf must be (N >= 1, 4), got {tuple(tf.shape)}")
    return _Lookup.apply(tf, density)


lookup.launches = 0


def load_1dt(path: str) -> np.ndarray:
    """Load an ImageVis3D .1dt transfer function (count line, then
    'r g b a' float rows)."""
    with open(path) as f:
        tokens = f.read().split()
    count = int(tokens[0])
    vals = np.asarray([float(t) for t in tokens[1 : 1 + 4 * count]], np.float32)
    return vals.reshape(count, 4)


def save_1dt(path: str, tf: np.ndarray) -> None:
    tf = np.asarray(tf, np.float32)
    with open(path, "w") as f:
        f.write(f"{tf.shape[0]}\n")
        for row in tf:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
