"""Device-resident brick atlas: one tensor of equally-sized slots
(``libre_tpu.ops.atlas``).

Reference: the CUDA texture-pool atlas (renderers/cudaRaycaster/cuda/
TexturePool.cu:101-214) — one device allocation carved into brick slots
with a free-list allocator, filled by async host→device copies; and the
GL TexturePool free-list (livre/core/render/TexturePool.cpp:89-127).

The pool is a ``(n_slots, BZ, BY, BX)`` tensor in the dataset's native
dtype; slot writes are in-place copies from pinned host memory with
``non_blocking=True`` on the current stream.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch


class AtlasFullError(RuntimeError):
    pass


# Unsigned dtypes whose slots are copied through the signed dtype of the
# same width: PyTorch's indexed copies do not take them.
_BITS_AS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or anything ``np.dtype`` takes) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class BrickAtlas:
    """Fixed-capacity device brick pool with a host-side free-list."""

    def __init__(
        self,
        n_slots: int,
        brick_shape_zyx: Tuple[int, int, int],
        dtype=torch.float32,
        device="cuda",
    ):
        self.n_slots = int(n_slots)
        self.brick_shape = tuple(int(b) for b in brick_shape_zyx)
        self.dtype = torch_dtype(dtype)
        self.device = torch.device(device)
        self._data = torch.zeros(
            (self.n_slots,) + self.brick_shape, dtype=self.dtype,
            device=self.device,
        )
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._lock = threading.Lock()
        # Orders slot writes against gathers issued from other threads
        # (upload pool vs. the frame thread): a gather enqueued after an
        # upload returned must see that upload.
        self._data_lock = threading.Lock()

    @property
    def data(self) -> torch.Tensor:
        """(n_slots, BZ, BY, BX) device tensor."""
        return self._data

    @property
    def slot_bytes(self) -> int:
        return int(np.prod(self.brick_shape)) * self._data.element_size()

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def acquire(self) -> int:
        """Pop a free slot (TexturePool.cu:175-186)."""
        with self._lock:
            if not self._free:
                raise AtlasFullError(
                    f"atlas exhausted ({self.n_slots} slots of {self.brick_shape})"
                )
            return self._free.pop()

    def release(self, slot: int) -> None:
        """Return a slot to the pool (TexturePool.cu:210-214)."""
        with self._lock:
            self._free.append(int(slot))

    def _host(self, bricks_zyx: np.ndarray) -> torch.Tensor:
        """Host tensor of the atlas dtype, pinned when the atlas is on a
        GPU so the copy can run asynchronously."""
        bricks = np.asarray(bricks_zyx)
        if bricks.shape[-3:] != self.brick_shape:
            raise ValueError(
                f"brick shape {bricks.shape} != slot {self.brick_shape}"
            )
        host = torch.from_numpy(np.ascontiguousarray(bricks)).to(self.dtype)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host

    def upload(self, slot: int, brick_zyx: np.ndarray) -> None:
        """Write a (BZ, BY, BX) brick into ``slot`` (async copy)."""
        host = self._host(brick_zyx)
        with self._data_lock:
            self._data[int(slot)].copy_(host, non_blocking=True)

    def upload_many(self, slots, bricks_zyx: np.ndarray) -> None:
        """Write a batch of bricks ((N, BZ, BY, BX)) in one copy and one
        indexed write."""
        host = self._host(bricks_zyx)
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(
            self.device, non_blocking=True
        )
        bits = _BITS_AS.get(self.dtype, self.dtype)
        with self._data_lock:
            dev = host.to(self.device, non_blocking=True)
            self._data.view(bits).index_copy_(0, idx, dev.view(bits))

    def gather(self, slots) -> torch.Tensor:
        """The given slots as a stacked (N, BZ, BY, BX) tensor."""
        idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)
        bits = _BITS_AS.get(self.dtype, self.dtype)
        with self._data_lock:
            return self._data.view(bits).index_select(0, idx).view(self.dtype)


def atlas_capacity(max_bytes: int, brick_shape_zyx, dtype=torch.float32) -> int:
    """Slots fitting a memory budget (TexturePool.cu:101-153 sizing)."""
    voxels = int(np.prod(brick_shape_zyx))
    per = voxels * torch.empty(0, dtype=torch_dtype(dtype)).element_size()
    return max(1, int(max_bytes) // per)
