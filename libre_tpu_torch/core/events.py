"""Event registry + interaction handlers.

Reference: livre/core/events/EventMapper.h (event-id → handler registry
with a factory fallback) and the eq-layer handlers
livre/eq/events/handlers/KeyboardHandler.cpp:38-108 (keys: 1-9/+/- tree
depth, i info, space camera reset, s statistics, p screenshot) and
ChannelPointerHandler.cpp:30-120 (button 1 orbit, button 2 dolly,
button 3 pan, wheel advance).  Handlers here mutate a FrameData — any
frontend (terminal app, HTTP steering, GUI) feeds events through the
mapper.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from libre_tpu_torch.core.settings import FrameData

EventHandler = Callable[..., bool]

ROTATE_AND_ZOOM_SPEED = 0.005
PAN_SPEED = 0.0005
ADVANCE_SPEED = 0.05

# Pointer button ids (eq::PTR_BUTTON*)
BUTTON_ORBIT = 1
BUTTON_DOLLY = 2
BUTTON_PAN = 3


class EventMapper:
    """Event-id → handler registry (EventMapper.h:31-80)."""

    def __init__(self, factory: Optional[Callable[[int], Optional[EventHandler]]] = None):
        self._factory = factory
        self._handlers: Dict[int, EventHandler] = {}

    def register_event(self, event_id: int, handler: Optional[EventHandler] = None) -> bool:
        if event_id in self._handlers:
            return False
        if handler is None and self._factory is not None:
            handler = self._factory(event_id)
        if handler is None:
            return False
        self._handlers[event_id] = handler
        return True

    def unregister_event(self, event_id: int) -> bool:
        return self._handlers.pop(event_id, None) is not None

    def get_event_handler(self, event_id: int) -> Optional[EventHandler]:
        return self._handlers.get(event_id)

    def handle_event(self, event_id: int, *args, **kwargs) -> bool:
        handler = self._handlers.get(event_id)
        if handler is None:
            return False
        return bool(handler(*args, **kwargs))


class KeyboardHandler:
    """Keyboard → settings mutations (KeyboardHandler.cpp:38-108)."""

    def __init__(self, frame_data: FrameData, reset_camera: Optional[Callable[[], None]] = None):
        self.frame_data = frame_data
        self._reset_camera = reset_camera

    def __call__(self, key: str) -> bool:
        rs = self.frame_data.render_settings
        fs = self.frame_data.frame_settings
        if len(key) == 1 and "1" <= key <= "9":
            rs.max_tree_depth = 1 + ord(key) - ord("1")
            return True
        if key in "+=":
            rs.max_tree_depth += 1
            return True
        if key in "-_":
            rs.max_tree_depth = max(0, rs.max_tree_depth - 1)
            return True
        if key in "iI":
            fs.toggle_info()
            return True
        if key == " ":
            if self._reset_camera is not None:
                self._reset_camera()
            return True
        if key in "sS":
            fs.toggle_statistics()
            return True
        if key in "pP":
            fs.make_screenshot()
            return True
        return False


class PointerHandler:
    """Mouse orbit/dolly/pan (ChannelPointerHandler.cpp:57-120)."""

    def __init__(self, frame_data: FrameData):
        self.frame_data = frame_data

    def motion(self, dx: float, dy: float, button: int) -> bool:
        cam = self.frame_data.camera_settings
        if button == BUTTON_ORBIT:
            cam.spin_model(-ROTATE_AND_ZOOM_SPEED * dy, -ROTATE_AND_ZOOM_SPEED * dx)
            return True
        if button == BUTTON_DOLLY:
            cam.move_camera(0.0, 0.0, ROTATE_AND_ZOOM_SPEED * -dy)
            return True
        if button == BUTTON_PAN:
            cam.move_camera(PAN_SPEED * dx, -PAN_SPEED * dy, 0.0)
            return True
        return False

    def wheel(self, x_axis: float, y_axis: float) -> bool:
        self.frame_data.camera_settings.move_camera(
            -ADVANCE_SPEED * x_axis, 0.0, ADVANCE_SPEED * y_axis
        )
        return True
