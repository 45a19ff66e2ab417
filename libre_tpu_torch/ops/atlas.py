"""Device-resident brick atlas: one tensor of equally-sized slots
(``libre_tpu.ops.atlas``).

Reference: the CUDA texture-pool atlas (renderers/cudaRaycaster/cuda/
TexturePool.cu:101-214) — one device allocation carved into brick slots
with a free-list allocator, filled by async host→device copies; and the
GL TexturePool free-list (livre/core/render/TexturePool.cpp:89-127).

The pool is a ``(n_slots, BZ, BY, BX)`` tensor in the dataset's native
dtype.  A batch upload stacks its bricks on the host (:meth:`_stack`),
copies them into pinned memory (:meth:`_pinned`) and writes them into
their slots with one asynchronous copy and one indexed write
(:meth:`_copy`) on the atlas's stream: the stream that was current when
the atlas was made.  Every upload, from any thread, lands on that stream,
so a kernel enqueued there before an upload into a slot reads the slot
before the upload writes it, and one enqueued after reads the upload.
Readers run on that stream too, whatever stream their caller is on:
:meth:`on_stream` moves their work there, ordered after the caller's
stream on entry, with the caller's stream ordered after it on exit.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Tuple

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
        # Orders slot writes from several threads (upload pool vs. the
        # frame thread) on the atlas's stream.
        self._data_lock = threading.Lock()
        self.stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )

    @contextlib.contextmanager
    def on_stream(self) -> Iterator[Optional[torch.cuda.Stream]]:
        """Run the enclosed device work on the atlas's stream, the one its
        uploads use, so that it is ordered with them whatever stream is
        current.  On entry the atlas's stream waits for the work already
        enqueued on the current stream; on exit the current stream waits
        for the atlas's (both through a CUDA event).  Yields the caller's
        stream when it is another stream, else None (and on a CPU atlas,
        where it does nothing)."""
        if self.stream is None:
            yield None
            return
        caller = torch.cuda.current_stream(self.device)
        if caller == self.stream:
            yield None
            return
        self.stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self.stream):
                yield caller
        finally:
            caller.wait_stream(self.stream)

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

    def _stack(self, bricks_zyx) -> np.ndarray:
        """(N, BZ, BY, BX) contiguous host array of a batch of bricks,
        given as one array or a sequence of (BZ, BY, BX) arrays."""
        if isinstance(bricks_zyx, np.ndarray):
            bricks = np.ascontiguousarray(bricks_zyx)
        else:
            bricks = np.stack(bricks_zyx)
        if bricks.shape[-3:] != self.brick_shape:
            raise ValueError(
                f"brick shape {bricks.shape} != slot {self.brick_shape}"
            )
        return bricks

    def _pinned(self, bricks: np.ndarray) -> torch.Tensor:
        """Host tensor of the atlas dtype, pinned when the atlas is on a
        GPU so the copy can run asynchronously."""
        host = torch.from_numpy(bricks).to(self.dtype)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host

    def _copy(self, slots, host: torch.Tensor) -> None:
        """Write ``host`` (N, BZ, BY, BX) into ``slots`` on the atlas's
        stream: one host → device copy and one indexed write."""
        bits = _BITS_AS.get(self.dtype, self.dtype)
        idx = torch.as_tensor(np.asarray(slots, np.int64))
        if self.device.type == "cuda":
            # A copy from pageable memory would wait for the stream.
            idx = idx.pin_memory()
        with self._data_lock, torch.cuda.stream(self.stream):
            idx = idx.to(self.device, non_blocking=True)
            dev = host.to(self.device, non_blocking=True)
            self._data.view(bits).index_copy_(0, idx, dev.view(bits))

    def upload(self, slot: int, brick_zyx: np.ndarray) -> None:
        """Write a (BZ, BY, BX) brick into ``slot`` (async copy)."""
        self.upload_many([slot], np.asarray(brick_zyx)[None])

    def upload_many(self, slots, bricks_zyx) -> None:
        """Write a batch of bricks ((N, BZ, BY, BX), or N arrays of
        (BZ, BY, BX)) into ``slots``."""
        self._copy(slots, self._pinned(self._stack(bricks_zyx)))

    def gather(self, slots) -> torch.Tensor:
        """The given slots as a stacked (N, BZ, BY, BX) tensor."""
        bits = _BITS_AS.get(self.dtype, self.dtype)
        with self._data_lock, self.on_stream() as caller:
            idx = torch.as_tensor(np.asarray(slots, np.int64)).to(self.device)
            out = self._data.view(bits).index_select(0, idx).view(self.dtype)
        if caller is not None:
            out.record_stream(caller)
        return out


def atlas_capacity(max_bytes: int, brick_shape_zyx, dtype=torch.float32) -> int:
    """Slots fitting a memory budget (TexturePool.cu:101-153 sizing)."""
    voxels = int(np.prod(brick_shape_zyx))
    per = voxels * torch.empty(0, dtype=torch_dtype(dtype)).element_size()
    return max(1, int(max_bytes) // per)
