"""Packed 64-bit octree node identifiers.

Bit layout matches the reference so that golden-value LOD-selection tests
carry over unchanged (reference: livre/core/types.h:190-196,
livre/core/data/NodeId.h:37-49):

    bits  0..3   level      (4 bits, max 15 levels; 15 == invalid)
    bits  4..17  block x    (14 bits)
    bits 18..31  block y    (14 bits)
    bits 32..45  block z    (14 bits)
    bits 46..63  time step  (18 bits)

Level 0 is the *coarsest* level.  Octree arithmetic (parent/children/range)
follows livre/core/data/NodeId.cpp:61-162.

Two representations are provided:

  * :class:`NodeId` — a tiny immutable Python value type for host-side tree
    walks (LOD selection, cache keys).
  * vectorized ``pack_ids`` / ``unpack_ids`` numpy helpers for bulk
    marshalling of brick tables that feed device kernels.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import numpy as np

LEVEL_BITS = 4
BLOCK_BITS = 14
TIMESTEP_BITS = 18

_LEVEL_MASK = (1 << LEVEL_BITS) - 1
_BLOCK_MASK = (1 << BLOCK_BITS) - 1
_TIME_MASK = (1 << TIMESTEP_BITS) - 1

_X_SHIFT = LEVEL_BITS
_Y_SHIFT = LEVEL_BITS + BLOCK_BITS
_Z_SHIFT = LEVEL_BITS + 2 * BLOCK_BITS
_T_SHIFT = LEVEL_BITS + 3 * BLOCK_BITS

INVALID_LEVEL = _LEVEL_MASK
INVALID_NODE_ID = (1 << 64) - 1


def pack(level: int, x: int, y: int, z: int, time_step: int = 0) -> int:
    """Pack octree coordinates into a 64-bit identifier."""
    return (
        (level & _LEVEL_MASK)
        | ((x & _BLOCK_MASK) << _X_SHIFT)
        | ((y & _BLOCK_MASK) << _Y_SHIFT)
        | ((z & _BLOCK_MASK) << _Z_SHIFT)
        | ((time_step & _TIME_MASK) << _T_SHIFT)
    )


def unpack(identifier: int) -> Tuple[int, int, int, int, int]:
    """Unpack a 64-bit identifier into (level, x, y, z, time_step)."""
    return (
        identifier & _LEVEL_MASK,
        (identifier >> _X_SHIFT) & _BLOCK_MASK,
        (identifier >> _Y_SHIFT) & _BLOCK_MASK,
        (identifier >> _Z_SHIFT) & _BLOCK_MASK,
        (identifier >> _T_SHIFT) & _TIME_MASK,
    )


def pack_ids(level, pos, time_step=0) -> np.ndarray:
    """Vectorized pack: ``pos`` is (..., 3) uint; returns uint64 ids."""
    level = np.asarray(level, dtype=np.uint64)
    pos = np.asarray(pos, dtype=np.uint64)
    t = np.asarray(time_step, dtype=np.uint64)
    return (
        (level & np.uint64(_LEVEL_MASK))
        | ((pos[..., 0] & np.uint64(_BLOCK_MASK)) << np.uint64(_X_SHIFT))
        | ((pos[..., 1] & np.uint64(_BLOCK_MASK)) << np.uint64(_Y_SHIFT))
        | ((pos[..., 2] & np.uint64(_BLOCK_MASK)) << np.uint64(_Z_SHIFT))
        | ((t & np.uint64(_TIME_MASK)) << np.uint64(_T_SHIFT))
    )


def unpack_ids(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized unpack: returns (level (N,), pos (N,3), time_step (N,))."""
    ids = np.asarray(ids, dtype=np.uint64)
    level = (ids & np.uint64(_LEVEL_MASK)).astype(np.uint32)
    pos = np.stack(
        [
            ((ids >> np.uint64(_X_SHIFT)) & np.uint64(_BLOCK_MASK)).astype(np.uint32),
            ((ids >> np.uint64(_Y_SHIFT)) & np.uint64(_BLOCK_MASK)).astype(np.uint32),
            ((ids >> np.uint64(_Z_SHIFT)) & np.uint64(_BLOCK_MASK)).astype(np.uint32),
        ],
        axis=-1,
    )
    t = ((ids >> np.uint64(_T_SHIFT)) & np.uint64(_TIME_MASK)).astype(np.uint32)
    return level, pos, t


class NodeId:
    """Immutable octree-node key (reference: livre/core/data/NodeId.h:35-130)."""

    __slots__ = ("_id",)

    def __init__(self, identifier: int = INVALID_NODE_ID):
        self._id = int(identifier) & INVALID_NODE_ID

    @classmethod
    def from_coords(cls, level: int, position, time_step: int = 0) -> "NodeId":
        x, y, z = (int(v) for v in position)
        return cls(pack(level, x, y, z, time_step))

    # -- accessors ---------------------------------------------------------
    @property
    def id(self) -> int:
        return self._id

    @property
    def level(self) -> int:
        return self._id & _LEVEL_MASK

    @property
    def time_step(self) -> int:
        return (self._id >> _T_SHIFT) & _TIME_MASK

    @property
    def position(self) -> Tuple[int, int, int]:
        return (
            (self._id >> _X_SHIFT) & _BLOCK_MASK,
            (self._id >> _Y_SHIFT) & _BLOCK_MASK,
            (self._id >> _Z_SHIFT) & _BLOCK_MASK,
        )

    def is_valid(self) -> bool:
        return self.level != INVALID_LEVEL

    def is_root(self) -> bool:
        return self.level == 0

    # -- tree arithmetic (NodeId.cpp:61-162) -------------------------------
    def parent(self) -> "NodeId":
        if self.level in (INVALID_LEVEL, 0):
            return NodeId()
        x, y, z = self.position
        return NodeId.from_coords(self.level - 1, (x // 2, y // 2, z // 2), self.time_step)

    def parents(self) -> List["NodeId"]:
        out = []
        p = self.parent()
        while p.is_valid():
            out.append(p)
            p = p.parent()
        return out

    def is_ancestor(self, other: "NodeId") -> bool:
        """True if ``other`` is an ancestor (coarser containing node) of self.

        Intent of NodeId::isParent (NodeId.cpp:70-84): ancestor position ==
        descendant position right-shifted by the level difference.
        """
        if other.level >= self.level or other.time_step != self.time_step:
            return False
        diff = self.level - other.level
        sx, sy, sz = self.position
        ox, oy, oz = other.position
        return (sx >> diff, sy >> diff, sz >> diff) == (ox, oy, oz)

    def children(self) -> List["NodeId"]:
        if self.level == INVALID_LEVEL:
            return []
        x, y, z = (2 * p for p in self.position)
        out = []
        for dx in range(2):
            for dy in range(2):
                for dz in range(2):
                    out.append(
                        NodeId.from_coords(
                            self.level + 1, (x + dx, y + dy, z + dz), self.time_step
                        )
                    )
        return out

    def children_at_level(self, level: int) -> List["NodeId"]:
        if self.level == INVALID_LEVEL or self.level >= level:
            return []
        n = 1 << (level - self.level)
        x, y, z = (p * n for p in self.position)
        out = []
        for dx in range(n):
            for dy in range(n):
                for dz in range(n):
                    out.append(
                        NodeId.from_coords(level, (x + dx, y + dy, z + dz), self.time_step)
                    )
        return out

    def root(self) -> "NodeId":
        n = 1 << self.level
        x, y, z = self.position
        return NodeId.from_coords(0, (x // n, y // n, z // n), self.time_step)

    def siblings(self) -> List["NodeId"]:
        if self.level in (INVALID_LEVEL, 0):
            return []
        return self.parent().children()

    def range(self) -> Tuple[float, float]:
        """Normalized [0,1) data range of this node (NodeId.cpp:128-137).

        Used for sort-last (DB) work decomposition: the interval positions
        the node within a z-major linearization of its level.
        """
        width = 1 << self.level
        n_children = width**3
        x, y, z = self.position
        position = x * width * width + y * width + z
        span = 1.0 / float(n_children)
        begin = float(position) / float(n_children)
        return (begin, begin + span)

    # -- dunder ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, NodeId):
            return self._id == other._id
        return self._id == other

    def __lt__(self, other) -> bool:
        if isinstance(other, NodeId):
            return self._id < other._id
        return self._id < other

    def __hash__(self) -> int:
        return hash(self._id)

    def __repr__(self) -> str:
        return f"NodeId(level={self.level}, pos={self.position}, t={self.time_step})"


class RootNode:
    """LOD-tree depth plus root-level block count (NodeId.h:136-168)."""

    __slots__ = ("depth", "block_count")

    def __init__(self, depth: int = 0, block_count=(0, 0, 0)):
        self.depth = int(depth)
        self.block_count = tuple(int(b) for b in block_count)

    def block_size(self, level: int = 0) -> Tuple[int, int, int]:
        """Upper bound on the number of blocks per axis at ``level``."""
        return tuple(b << level for b in self.block_count)

    def iter_roots(self, time_step: int = 0) -> Iterator[NodeId]:
        bx, by, bz = self.block_count
        for x in range(bx):
            for y in range(by):
                for z in range(bz):
                    yield NodeId.from_coords(0, (x, y, z), time_step)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, RootNode)
            and self.depth == other.depth
            and self.block_count == other.block_count
        )

    def __repr__(self) -> str:
        return f"RootNode(depth={self.depth}, block_count={self.block_count})"
