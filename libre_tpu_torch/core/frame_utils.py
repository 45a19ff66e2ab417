"""Frame-range clamping and animation frame arithmetic
(livre/core/util/FrameUtils.{h,cpp}): wrap-around next-frame computation
with signed delta and a latest-frame mode."""

from __future__ import annotations

from typing import Optional, Tuple

INVALID_TIMESTEP = 0xFFFFFFFF
INVALID_FRAME_RANGE = (INVALID_TIMESTEP, INVALID_TIMESTEP)


class FrameUtils:
    """Half-open frame range [start, end) clamped to ``boundaries``
    (FrameUtils.cpp:48-56, 116-129)."""

    def __init__(
        self, frame_range: Tuple[int, int], boundaries: Tuple[int, int]
    ):
        self._range = INVALID_FRAME_RANGE
        if frame_range[1] <= boundaries[0] or frame_range[0] >= boundaries[1]:
            return  # entirely outside ⇒ invalid (FrameUtils.cpp:51-52)
        self._range = (
            max(frame_range[0], boundaries[0]),
            min(frame_range[1], boundaries[1]),
        )

    @property
    def frame_range(self) -> Tuple[int, int]:
        return self._range

    @property
    def is_valid(self) -> bool:
        return self._range != INVALID_FRAME_RANGE

    def get_current(self, frame_number: int, latest_always: bool = False) -> int:
        """Clamp ``frame_number`` into the range; latest mode pins to the
        last frame (FrameUtils.cpp:63-77)."""
        if not self.is_valid:
            return INVALID_TIMESTEP
        last = self._range[1] - 1
        if latest_always:
            return last
        current = 0 if frame_number == INVALID_TIMESTEP else frame_number
        return min(max(self._range[0], current), last)

    def get_next(self, current: int, delta: int) -> int:
        """Advance by ``delta`` with wrap-around at either end
        (FrameUtils.cpp:79-92)."""
        if not self.is_valid:
            return INVALID_TIMESTEP
        interval = self._range[1] - self._range[0]
        if current == self._range[0] and delta < 0:
            current = self._range[1]
        return (current - self._range[0] + delta) % interval + self._range[0]
