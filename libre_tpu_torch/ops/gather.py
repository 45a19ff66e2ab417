"""The gather kernels behind the port's probes (``libre_tpu_torch/benchmarks``).

The JAX package's ``benchmarks/probe_*.py`` measure, as Pallas kernels on a
TPU, the gathers its renderers are built from: a flat ``take``, a
``take_along_axis`` on either axis (alone or summed over a loop of
shifted indices), and the TF lookup by density, nearest or two-tap
linear.  Here each of those four functions is one hand-written CUDA
kernel (``csrc/probe_take.cu``, ``probe_take_along.cu``,
``probe_tf_nearest.cu``, ``probe_tf_linear.cu``) with its plain PyTorch
version beside it.

Each wrapper checks dtype, shape, device and contiguity and raises on
what its kernel does not take; on CPU tensors it runs its plain version
(``<wrapper>.reference``), on CUDA tensors it launches the kernel on the
current stream and adds one to ``<wrapper>.launches``.  Indices are
int32 and must lie in their table: the plain versions raise on one
outside it, the kernels read nothing for it and give NaN (jnp's fill
mode).  The kernels' outputs are bit for bit their plain versions':
gathers copy, the loop sums add in the reference's order, and the TF
arithmetic is built with ``--fmad=false``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _kernels

_MAX_ELEMENTS = 2**30  # the kernels index with 32-bit ints
_MAX_TF_FLOATS = 48 * 1024 // 4  # the TF kernels' table in static-size shared memory


def _check(what: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_operands(what: str, floats, ints=()) -> torch.device:
    """float32 ``floats`` and int32 ``ints``, contiguous, on one device."""
    device = floats[0].device
    for t, dtype in [(t, torch.float32) for t in floats] + [(t, torch.int32) for t in ints]:
        _check(what, t.dtype == dtype, f"expected {dtype}, got {t.dtype}")
        _check(what, t.is_contiguous(), "operands must be contiguous")
        _check(what, t.device == device, f"operands on {t.device} and {device}")
        _check(what, t.numel() <= _MAX_ELEMENTS, f"{t.numel()} elements")
    _check(what, device.type in ("cpu", "cuda"), f"no kernel for device {device}")
    return device


# ====================================================================== take
def take_reference(
    table: torch.Tensor, idx: torch.Tensor, lane: Optional[torch.Tensor] = None, *, row: int = 1
) -> torch.Tensor:
    """Plain PyTorch ``take``: ``out[j, c] = table.flatten()[idx[j]·row + c]``
    for ``c < row`` (``out`` has ``idx``'s shape for ``row`` 1, and a
    trailing ``row`` axis otherwise), or with ``lane``
    ``out[j] = table[idx[j], lane[j]]`` of a 2-D table."""
    if lane is not None:
        return table[idx.long(), lane.long()]
    if row == 1:
        return torch.take(table, idx.long())
    rows = table.reshape(-1, row).index_select(0, idx.reshape(-1))
    return rows.reshape(*idx.shape, row)


def take(
    table: torch.Tensor, idx: torch.Tensor, lane: Optional[torch.Tensor] = None, *, row: int = 1
) -> torch.Tensor:
    """:func:`take_reference` by ``csrc/probe_take.cu`` on CUDA tensors.

    Serves the probes' flat takes (P1, P14), their row take (P9,
    ``row=128``) and the (row, lane) take of a 2-D table (P15, whose
    kernel forms ``row·width + lane`` itself)."""
    what = "take"
    device = _check_operands(what, [table], [idx] + ([lane] if lane is not None else []))
    _check(what, row >= 1, f"row {row}")
    if lane is not None:
        _check(what, row == 1 and table.dim() == 2, "a lane index needs row 1 and a 2-D table")
        _check(what, lane.shape == idx.shape, f"lane {tuple(lane.shape)} vs idx {tuple(idx.shape)}")
    _check(what, table.numel() % row == 0, f"{table.numel()} values are no whole rows of {row}")
    _check(what, idx.numel() * row <= _MAX_ELEMENTS, "output too large")
    if device.type == "cpu":
        return take_reference(table, idx, lane, row=row)
    out_shape = tuple(idx.shape) if row == 1 else (*idx.shape, row)
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        _kernels.launch(
            "probe_take", table, idx, lane, out,
            out.numel(), row, table.shape[-1] if lane is not None else 0, table.numel(),
        )
    take.launches += 1
    return out


take.launches = 0
take.reference = take_reference


# ================================================================ take_along
def _wrap(i: torch.Tensor, mod: Optional[int]) -> torch.Tensor:
    return i if mod is None else torch.remainder(i, mod)


def take_along_reference(
    table: torch.Tensor, idx: torch.Tensor, axis: int, *, loop: int = 1, mod: Optional[int] = None
) -> torch.Tensor:
    """Plain PyTorch ``take_along``: for ``loop`` 1
    ``out[r, l] = table[r, i]`` along axis 1 or ``table[i, l]`` along
    axis 0, with ``i = idx[r, l] % mod`` (``idx[r, l]`` without ``mod``);
    for ``loop`` > 1 the sum over ``k < loop`` of the same with
    ``i = (idx[r, l] + k) % mod``, from 0 in the order of ``k`` (the
    reference's ``fori_loop``)."""
    if loop == 1:
        return torch.gather(table, axis, _wrap(idx, mod).long())
    acc = torch.zeros(idx.shape, dtype=table.dtype, device=table.device)
    for k in range(loop):
        acc = acc + torch.gather(table, axis, _wrap(idx + k, mod).long())
    return acc


def take_along(
    table: torch.Tensor, idx: torch.Tensor, axis: int, *, loop: int = 1, mod: Optional[int] = None
) -> torch.Tensor:
    """:func:`take_along_reference` by ``csrc/probe_take_along.cu`` on
    CUDA tensors.  ``table`` and ``idx`` are 2-D and agree off ``axis``;
    along it the table may be wider or taller than the index.

    Serves the probes' ``take_along_axis`` lookups (P2-P4, P7, P10, P16:
    a kernel of their own, one chain of two loads a thread) and their loop
    sums (P5, P6, P8: the part of the table a warp's outputs read staged in
    shared memory, up to 48 KB of it; past that, one thread per output
    reading the table through L1)."""
    what = "take_along"
    device = _check_operands(what, [table], [idx])
    _check(what, table.dim() == 2 and idx.dim() == 2, "table and idx must be 2-D")
    _check(what, axis in (0, 1), f"axis {axis}")
    other = 1 - axis
    _check(what, table.shape[other] == idx.shape[other],
           f"table {tuple(table.shape)} and idx {tuple(idx.shape)} differ off axis {axis}")
    _check(what, loop >= 1, f"loop {loop}")
    _check(what, mod is None or 1 <= mod <= table.shape[axis],
           f"mod {mod} outside [1, {table.shape[axis]}]")
    if device.type == "cpu":
        return take_along_reference(table, idx, axis, loop=loop, mod=mod)
    out = torch.empty(idx.shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        _kernels.launch(
            "probe_take_along", table, idx, out,
            idx.shape[0], idx.shape[1], table.shape[0], table.shape[1], axis, loop, mod or 0,
        )
    take_along.launches += 1
    return out


take_along.launches = 0
take_along.reference = take_along_reference


# ================================================================ tf_nearest
OUTSIDE = ("clip", "zero")


def tf_nearest_reference(
    d: torch.Tensor, tf: torch.Tensor, *, scale: float, outside: str = "clip"
) -> torch.Tensor:
    """Plain PyTorch nearest TF lookup, channels last (``d.shape`` for a
    (T,) table, ``d.shape + (C,)`` for (T, C)).  ``outside`` "clip":
    ``tf[clip(trunc(d·scale), 0, T − 1)]`` (P11, P13); "zero":
    ``tf[⌊d·scale⌋]``, and 0 where that falls outside [0, T) (P17, whose
    one-hot row is then empty)."""
    t_size = tf.shape[0]
    s = d * scale
    if outside == "clip":
        return tf[torch.clamp(torch.trunc(s), 0.0, float(t_size - 1)).long()]
    s = torch.floor(s)
    inside = (s >= 0.0) & (s < float(t_size))
    got = tf[torch.clamp(s, 0.0, float(t_size - 1)).long()]
    if tf.dim() == 2:
        inside = inside[..., None]
    return torch.where(inside, got, torch.zeros((), dtype=tf.dtype, device=tf.device))


def tf_nearest(
    d: torch.Tensor, tf: torch.Tensor, *, scale: float, outside: str = "clip"
) -> torch.Tensor:
    """:func:`tf_nearest_reference` by ``csrc/probe_tf_nearest.cu`` on
    CUDA tensors (P11, P13, P17): one thread per density, the table read
    through L1; float4 densities (C = 1) or rows (C = 4) where the
    operands are 16 B aligned, else the density's C values one by one."""
    what = "tf_nearest"
    device = _check_operands(what, [d, tf])
    _check(what, tf.dim() in (1, 2) and tf.shape[0] >= 1, f"tf {tuple(tf.shape)}: (T,) or (T, C)")
    _check(what, tf.numel() <= _MAX_TF_FLOATS, f"a table of {tf.numel()} values")
    _check(what, outside in OUTSIDE, f"outside {outside!r} not in {OUTSIDE}")
    channels = tf.shape[1] if tf.dim() == 2 else 1
    _check(what, d.numel() * channels <= _MAX_ELEMENTS, "output too large")
    if device.type == "cpu":
        return tf_nearest_reference(d, tf, scale=scale, outside=outside)
    out_shape = tuple(d.shape) + ((channels,) if tf.dim() == 2 else ())
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(device):
        _kernels.launch(
            "probe_tf_nearest", d, tf, out,
            out.numel(), tf.shape[0], channels, float(scale), int(outside == "zero"),
        )
    tf_nearest.launches += 1
    return out


tf_nearest.launches = 0
tf_nearest.reference = tf_nearest_reference


# ================================================================= tf_linear
def tf_linear_reference(d: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch two-tap linear TF lookup (P12): for d (K, ...) and
    tf (C, T), ``s = clip(clip(d, 0, 1)·T − 0.5, 0, T − 1)``,
    ``i0 = ⌊s⌋``, ``i1 = min(i0 + 1, T − 1)``, ``w = s − i0`` and
    ``out[k, c] = tf[c, i0]·(1 − w) + tf[c, i1]·w``: (K, C, ...), channels
    before the rows as the reference's ``f2`` writes them."""
    t_size = tf.shape[1]
    s = torch.clamp(d, 0.0, 1.0) * t_size - 0.5
    s = torch.clamp(s, 0.0, float(t_size - 1))
    i0 = torch.floor(s)
    w = s - i0
    i0 = i0.long()
    i1 = torch.clamp(i0 + 1, max=t_size - 1)
    out = tf[:, i0] * (1.0 - w) + tf[:, i1] * w  # (C, K, ...)
    return out.movedim(0, 1).contiguous()


def tf_linear(d: torch.Tensor, tf: torch.Tensor) -> torch.Tensor:
    """:func:`tf_linear_reference` by ``csrc/probe_tf_linear.cu`` on CUDA
    tensors: the (C, T) table staged in shared memory once per block."""
    what = "tf_linear"
    device = _check_operands(what, [d, tf])
    _check(what, d.dim() >= 1, "d needs a leading plane axis")
    _check(what, tf.dim() == 2 and tf.shape[1] >= 1, f"tf {tuple(tf.shape)}: (C, T)")
    _check(what, tf.numel() <= _MAX_TF_FLOATS, f"a table of {tf.numel()} values")
    _check(what, d.numel() * tf.shape[0] <= _MAX_ELEMENTS, "output too large")
    if device.type == "cpu":
        return tf_linear_reference(d, tf)
    out = torch.empty((d.shape[0], tf.shape[0], *d.shape[1:]), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    plane = d[0].numel()
    with torch.cuda.device(device):
        _kernels.launch(
            "probe_tf_linear", d, tf, out, d.shape[0], plane, tf.shape[1], tf.shape[0],
        )
    tf_linear.launches += 1
    return out


tf_linear.launches = 0
tf_linear.reference = tf_linear_reference

KERNELS = {"probe_take": take, "probe_take_along": take_along,
           "probe_tf_nearest": tf_nearest, "probe_tf_linear": tf_linear}
