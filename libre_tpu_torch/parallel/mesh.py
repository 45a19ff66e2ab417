"""The (ray × brick) device mesh (``libre_tpu.parallel.mesh``).

The two first-class axes mirror the reference's decompositions
(SURVEY.md §2.12):

  * ``ray``  — sort-first: each shard owns a contiguous slab of rays
    (the Equalizer per-channel viewport, Channel.cpp:444-533 2D path);
  * ``brick`` — sort-last/DB: each shard owns a contiguous range of the
    front-to-back brick list or plane grid (the channel ``Range`` slicing
    the visible set, SelectVisibles.cpp:120-142) and composites a
    partial image.

One process drives every shard of a :class:`Mesh`, as one controller
drives a JAX ``Mesh`` under ``shard_map``: a shard body is a plain
function called once per mesh coordinate ``(vd, kd)`` with its operands
on that shard's device.  A device may repeat: ``[cuda:0] * 4`` runs four
logical shards on one card, ``[cpu] * 4`` four on the host.  The brick
axis is the minor (fastest-varying) one, since its compositing
communicates per-ray (rgb, a) every frame while the ray axis needs no
communication at all; across processes the ray axis is the one that
spans them (``parallel/distributed.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import torch

RAY_AXIS = "ray"
BRICK_AXIS = "brick"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(n_ray, n_brick)`` grid of ``torch.device``s with the axis
    names (``ray``, ``brick``)."""

    devices: Tuple[Tuple[torch.device, ...], ...]  # [vd][kd]
    axis_names: Tuple[str, str] = (RAY_AXIS, BRICK_AXIS)

    def __post_init__(self):
        rows = {len(r) for r in self.devices}
        if not self.devices or len(rows) != 1 or 0 in rows:
            raise ValueError(f"mesh rows must be non-empty and equal, got {self.devices}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as a JAX mesh's ``shape``."""
        return {RAY_AXIS: len(self.devices), BRICK_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def lead(self) -> torch.device:
        """The device of shard (0, 0): where folded results land."""
        return self.devices[0][0]

    def device(self, vd: int, kd: int) -> torch.device:
        return self.devices[vd][kd]

    def shards(self) -> Iterator[Tuple[int, int, torch.device]]:
        """Every ``(vd, kd, device)``, ray-major, brick-minor."""
        for vd, row in enumerate(self.devices):
            for kd, dev in enumerate(row):
                yield vd, kd, dev

    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in shard order."""
        out = []
        for _vd, _kd, dev in self.shards():
            if dev not in out:
                out.append(dev)
        return tuple(out)


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices() -> Tuple[torch.device, ...]:
    """Every CUDA device of this process, in index order."""
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(
    n_brick: int = 1,
    n_ray: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(ray, brick)`` mesh over ``devices`` (default: every CUDA
    device of this process).  ``n_ray`` defaults to
    ``len(devices) // n_brick``.  A device may appear more than once."""
    devices = local_devices() if devices is None else tuple(as_device(d) for d in devices)
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh: no devices")
    if n_ray is None:
        if n % n_brick:
            raise ValueError(f"{n} devices not divisible by n_brick={n_brick}")
        n_ray = n // n_brick
    if n_brick < 1 or n_ray < 1:
        raise ValueError(f"mesh {n_ray}x{n_brick} has an empty axis")
    if n_brick * n_ray > n:
        raise ValueError(
            f"mesh {n_brick}x{n_ray} needs {n_brick * n_ray} devices, have {n}"
        )
    grid = tuple(
        tuple(devices[vd * n_brick + kd] for kd in range(n_brick)) for vd in range(n_ray)
    )
    return Mesh(grid)


def parse_mesh(arg: str, devices: Optional[Sequence] = None) -> Mesh:
    """``--mesh`` of the apps: ``"RxB"`` (ray × brick shards over
    ``devices``) or ``"auto"``: every device, two on the brick axis when
    their count is even and above one, as the JAX CLI does."""
    devices = local_devices() if devices is None else tuple(devices)
    if arg == "auto":
        n = len(devices)
        n_brick = 2 if n % 2 == 0 and n > 1 else 1
        return make_mesh(n_brick=n_brick, n_ray=n // n_brick, devices=devices)
    try:
        r, b = (int(x) for x in arg.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {arg!r}: expected RxB (e.g. 2x2) or auto") from None
    return make_mesh(n_brick=b, n_ray=r, devices=devices)


def require_mesh(who: str, mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`, else a TypeError naming ``who``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{who}: mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh
