"""Mutable per-session settings (livre/core/settings/*): camera, frame,
render, volume, application state.

These are the small replicated-state pytree of a distributed session — the
FrameData equivalent (livre/eq/FrameData.h): the app process mutates them,
``as_pytree``/``update_pytree`` broadcast them to render processes each
frame (SURVEY.md §5.8: FrameData ≙ host-broadcast pytree).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from libre_tpu_torch.core.clip_planes import ClipPlanes
from libre_tpu_torch.core.frustum import look_at
from libre_tpu_torch.core.signalled import SignalledVariable
from libre_tpu_torch.ops.transfer_function import default_color_map


def _rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rotation_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


class CameraSettings:
    """Modelview matrix with orbit/translate manipulation
    (livre/core/settings/CameraSettings.cpp)."""

    def __init__(self):
        self._modelview: SignalledVariable[np.ndarray] = SignalledVariable(
            np.eye(4, dtype=np.float32)
        )

    def on_changed(self, callback: Callable[[np.ndarray], None]) -> None:
        self._modelview.on_changed(callback)

    def spin_model(self, x: float, y: float) -> None:
        """Rotate around x/y keeping the translation fixed
        (CameraSettings.cpp:spinModel — pre-rotations with the translation
        column restored)."""
        if x == 0.0 and y == 0.0:
            return
        mv = self._modelview.get().copy()
        translation = mv[:3, 3].copy()
        mv[:3, 3] = 0.0
        mv = _rotation_x(x) @ _rotation_y(y) @ mv
        mv[:3, 3] = translation
        self._modelview.set(mv)

    def move_camera(self, x: float, y: float, z: float) -> None:
        mv = self._modelview.get().copy()
        mv[:3, 3] += (x, y, z)
        self._modelview.set(mv)

    def set_camera_position(self, position) -> None:
        mv = self._modelview.get().copy()
        mv[:3, 3] = position
        self._modelview.set(mv)

    def set_camera_look_at(self, look_at_point) -> None:
        """Re-orient toward a point, nudging `up` near the poles to avoid
        gimbal lock (CameraSettings.cpp:setCameraLookAt)."""
        eye = self._modelview.get()[:3, 3].copy()
        z_axis = np.asarray(eye, np.float64) - np.asarray(look_at_point, np.float64)
        n = np.linalg.norm(z_axis)
        if n > 0:
            z_axis /= n
        up = np.array([0.0, 1.0, 0.0])
        angle = float(z_axis @ up)
        if 1.0 - abs(angle) < 1e-4:
            right = np.array([1.0, 0.0, 0.0]) if angle <= 0 else np.array([-1.0, 0.0, 0.0])
            c, s = np.cos(0.01), np.sin(0.01)
            up = up * c + np.cross(right, up) * s
            up /= np.linalg.norm(up)
        self._modelview.set(look_at(eye, look_at_point, up).astype(np.float32))

    def set_modelview_matrix(self, modelview: np.ndarray) -> None:
        self._modelview.set(np.asarray(modelview, np.float32))

    def get_modelview_matrix(self) -> np.ndarray:
        return self._modelview.get()


class FrameSettings:
    """Frame number, screenshot/grab flags, overlay toggles
    (livre/core/settings/FrameSettings.h)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.frame_number = 0xFFFFFFFF
        self.screenshot_number = 0
        self.statistics = False
        self.show_info = False
        self.grab_frame = False

    def toggle_info(self) -> None:
        self.show_info = not self.show_info

    def toggle_statistics(self) -> None:
        self.statistics = not self.statistics

    def make_screenshot(self) -> None:
        self.screenshot_number += 1


class RenderSettings:
    """Colormap + clip planes + max rendering depth
    (livre/core/settings/RenderSettings.h)."""

    def __init__(self):
        self.color_map = default_color_map()
        self.clip_planes = ClipPlanes()
        self.max_tree_depth = (1 << 4) - 1

    def reset_color_map(self) -> None:
        self.color_map = default_color_map()


class VolumeSettings:
    """Volume URI + accumulated data-source range
    (livre/core/settings/VolumeSettings.h)."""

    def __init__(self):
        self.uri = ""
        self.data_source_range = (0.0, 1.0)


class ApplicationSettings:
    """Resource folders + renderer name
    (livre/core/settings/ApplicationSettings.h)."""

    def __init__(self):
        self.resource_folders: List[str] = []
        self.renderer = "xla"


@dataclasses.dataclass
class FrameData:
    """The per-frame replicated state bundle (livre/eq/FrameData.h:32-147).

    Collage object sync becomes a plain host-side pytree broadcast: the
    controller process serializes ``as_pytree()`` and render processes
    apply it before drawing.
    """

    camera_settings: CameraSettings = dataclasses.field(default_factory=CameraSettings)
    frame_settings: FrameSettings = dataclasses.field(default_factory=FrameSettings)
    render_settings: RenderSettings = dataclasses.field(default_factory=RenderSettings)
    volume_settings: VolumeSettings = dataclasses.field(default_factory=VolumeSettings)
    app_settings: ApplicationSettings = dataclasses.field(default_factory=ApplicationSettings)

    def as_pytree(self) -> dict:
        return {
            "modelview": np.asarray(self.camera_settings.get_modelview_matrix()),
            "frame_number": self.frame_settings.frame_number,
            "grab_frame": self.frame_settings.grab_frame,
            "color_map": np.asarray(self.render_settings.color_map),
            "clip_planes": self.render_settings.clip_planes.as_array(),
            "max_tree_depth": self.render_settings.max_tree_depth,
            "uri": self.volume_settings.uri,
            "data_source_range": tuple(self.volume_settings.data_source_range),
            "renderer": self.app_settings.renderer,
        }

    def update_pytree(self, tree: dict) -> None:
        self.camera_settings.set_modelview_matrix(tree["modelview"])
        self.frame_settings.frame_number = int(tree["frame_number"])
        self.frame_settings.grab_frame = bool(tree["grab_frame"])
        self.render_settings.color_map = np.asarray(tree["color_map"])
        self.render_settings.clip_planes = ClipPlanes(tree["clip_planes"])
        self.render_settings.max_tree_depth = int(tree["max_tree_depth"])
        self.volume_settings.uri = tree["uri"]
        self.volume_settings.data_source_range = tuple(tree["data_source_range"])
        self.app_settings.renderer = tree["renderer"]
