"""Byte-buffer handles (livre/core/data/MemoryUnit.h:34-166); a copy of
``libre_tpu/data/memory_unit.py`` (numpy only, no kernel).

The reference distinguishes non-owning views (ConstMemoryUnit — e.g.
into an mmap, RawDataSource.cpp:123-129), owning copies (AllocMemoryUnit)
and the empty unit.  numpy expresses the same distinction through the
``base``/ownership machinery; these thin wrappers keep the vocabulary for
datasource implementations and make the owning/non-owning contract
explicit at API boundaries.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class MemoryUnit:
    """Abstract byte-buffer handle."""

    def get_data(self, dtype=np.uint8) -> np.ndarray:
        raise NotImplementedError

    @property
    def mem_size(self) -> int:
        raise NotImplementedError

    @property
    def alloc_size(self) -> int:
        return self.mem_size


class NoMemoryUnit(MemoryUnit):
    """The empty unit (MemoryUnit.h NoMemoryUnit)."""

    def get_data(self, dtype=np.uint8) -> np.ndarray:
        return np.empty(0, dtype)

    @property
    def mem_size(self) -> int:
        return 0


class ConstMemoryUnit(MemoryUnit):
    """Non-owning view into caller-owned memory (e.g. an mmap)."""

    def __init__(self, array: np.ndarray):
        # A read-only view of the caller's memory — never a copy, and the
        # caller's own array is left untouched.
        view = np.asarray(array)[...]
        view.flags.writeable = False
        self._view = view

    def get_data(self, dtype=np.uint8) -> np.ndarray:
        return self._view.view(dtype)

    @property
    def mem_size(self) -> int:
        return self._view.nbytes


class AllocMemoryUnit(MemoryUnit):
    """Owning copy (MemoryUnit.h AllocMemoryUnit::allocAndSetData)."""

    def __init__(self, array_or_size):
        if isinstance(array_or_size, (int, np.integer)):
            self._data = np.zeros(int(array_or_size), np.uint8)
        else:
            self._data = np.array(array_or_size, copy=True)

    def get_data(self, dtype=np.uint8) -> np.ndarray:
        return self._data.view(dtype)

    @property
    def mem_size(self) -> int:
        return self._data.nbytes
