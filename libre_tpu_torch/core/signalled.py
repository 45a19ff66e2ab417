"""Value with an on-assignment callback (livre/core/data/
SignalledVariable.h:31-71) — used by the settings classes to trigger
redraws / steering publishes on change."""

from __future__ import annotations

from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class SignalledVariable(Generic[T]):
    def __init__(self, value: T, callback: Optional[Callable[[T], None]] = None):
        self._value = value
        self._callback = callback

    def get(self) -> T:
        return self._value

    def set(self, value: T) -> None:
        self._value = value
        if self._callback is not None:
            self._callback(value)

    def on_changed(self, callback: Callable[[T], None]) -> None:
        self._callback = callback
