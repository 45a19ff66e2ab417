"""Typed option dictionary + parameter blocks (livre/core/configuration/
Configuration.h:32-129, Parameters.h; livre/lib/configuration/
ApplicationParameters.cpp:40-128; RendererParameters.{h,cpp} with the
defaults of rendererParameters.fbs:3-12).

boost::program_options becomes a small typed registry with groups,
defaults, implicit values, command-line and key=value config-file parsing.
The parameter dataclasses mirror the reference's flags (user-guide.dox:
81-113) so a Libre user's command lines keep working.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type


class ConfigurationError(ValueError):
    pass


@dataclasses.dataclass
class _Option:
    name: str
    type: Type
    default: Any
    description: str
    group: str
    n_args: int  # -1 = variable-length list
    implicit: Any  # value when the flag appears with no argument


class Configuration:
    """Option registry with groups, defaults, implicit values, and
    cmdline/file parsing (Configuration.h:32-129)."""

    def __init__(self):
        self._options: Dict[str, _Option] = {}
        self._values: Dict[str, Any] = {}

    def add_option(
        self,
        name: str,
        description: str,
        default: Any = None,
        type: Optional[Type] = None,
        group: str = "",
        n_args: int = 1,
        implicit: Any = None,
    ) -> None:
        opt_type = type
        if opt_type is None:
            opt_type = default.__class__ if default is not None else str
        self._options[name] = _Option(
            name, opt_type, default, description, group, n_args, implicit
        )
        if default is not None:
            self._values[name] = default

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._options:
            raise ConfigurationError(f"unknown option {name!r}")
        return self._values.get(name, default)

    def set(self, name: str, value: Any) -> None:
        if name not in self._options:
            raise ConfigurationError(f"unknown option {name!r}")
        self._values[name] = value

    def parse_args(self, argv: Sequence[str]) -> List[str]:
        """Parse ``--name value...`` tokens; returns unrecognized tokens
        (they may belong to another Parameters block, as with the
        reference's parse-allow-unregistered)."""
        rest: List[str] = []
        i = 0
        argv = list(argv)
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                rest.append(tok)
                i += 1
                continue
            name, eq, inline = tok[2:].partition("=")
            if name not in self._options:
                rest.append(tok)
                i += 1
                continue
            opt = self._options[name]
            if eq:
                args = [inline]
                i += 1
            else:
                args = []
                j = i + 1
                limit = len(argv) if opt.n_args < 0 else i + 1 + opt.n_args
                while j < len(argv) and j < limit and not argv[j].startswith("--"):
                    args.append(argv[j])
                    j += 1
                i = j
            self._values[name] = self._convert(opt, args)
        return rest

    def parse_file(self, path: str) -> None:
        """key = value lines (# comments) — the config-file half of
        boost::program_options."""
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                name, _, value = line.partition("=")
                name = name.strip()
                if name not in self._options:
                    raise ConfigurationError(f"unknown option {name!r} in {path}")
                opt = self._options[name]
                self._values[name] = self._convert(opt, shlex.split(value))

    def _convert(self, opt: _Option, args: List[str]) -> Any:
        if not args:
            if opt.implicit is not None:
                return opt.implicit
            if opt.type is bool:
                return True
            raise ConfigurationError(f"option --{opt.name} needs a value")
        if opt.n_args == 1:
            if opt.type is bool:
                return args[0].lower() in ("1", "true", "yes", "on")
            return opt.type(args[0])
        vals = [opt.type(a) for a in args]
        if opt.n_args > 0 and len(vals) != opt.n_args:
            raise ConfigurationError(
                f"option --{opt.name} takes {opt.n_args} values, got {len(vals)}"
            )
        return vals

    def help_text(self) -> str:
        groups: Dict[str, List[_Option]] = {}
        for opt in self._options.values():
            groups.setdefault(opt.group, []).append(opt)
        out = []
        for group, opts in groups.items():
            if group:
                out.append(f"{group}:")
            for o in opts:
                default = f" (default: {o.default})" if o.default is not None else ""
                out.append(f"  --{o.name:<24} {o.description}{default}")
        return "\n".join(out)


class Parameters:
    """Base for parameter blocks: owns a Configuration, ``initialize``
    parses argv and calls the subclass hook (Parameters.{h,cpp})."""

    def __init__(self, group: str):
        self.configuration = Configuration()
        self._group = group
        self._register()

    def _register(self) -> None:
        raise NotImplementedError

    def _apply(self) -> None:
        raise NotImplementedError

    def initialize(self, argv: Sequence[str]) -> List[str]:
        rest = self.configuration.parse_args(argv)
        self._apply()
        return rest


class RendererParameters(Parameters):
    """Rendering flags with the .fbs defaults (rendererParameters.fbs:3-12;
    CLI names from RendererParameters.cpp / user-guide.dox:99-113)."""

    def __init__(self, argv: Sequence[str] = ()):
        self.max_lod = (1 << 4) - 1
        self.min_lod = 0
        self.screen_space_error = 4.0
        self.synchronous_mode = False
        self.samples_per_ray = 0  # 0 = auto (Nyquist, min 512)
        self.samples_per_pixel = 1
        self.max_gpu_cache_memory_mb = 3072
        self.max_cpu_cache_memory_mb = 8192
        super().__init__("Renderer Parameters")
        if argv:
            self.initialize(argv)

    def _register(self) -> None:
        g = self._group
        add = self.configuration.add_option
        add("sse", "Screen space error", 4.0, group=g)
        add("min-lod", "Minimum level of detail", 0, group=g)
        add("max-lod", "Maximum level of detail", (1 << 4) - 1, group=g)
        add("samples-per-ray", "Number of samples per ray (0 = auto)", 0, group=g)
        add("samples-per-pixel", "Number of samples per pixel", 1, group=g)
        add("synchronous", "Enable synchronous mode", False, group=g)
        add("gpu-cache-mem", "Maximum GPU cache memory (MB)", 3072, group=g)
        add("cpu-cache-mem", "Maximum CPU cache memory (MB)", 8192, group=g)

    def _apply(self) -> None:
        c = self.configuration
        self.screen_space_error = c.get("sse")
        self.min_lod = c.get("min-lod")
        self.max_lod = c.get("max-lod")
        self.samples_per_ray = c.get("samples-per-ray")
        self.samples_per_pixel = c.get("samples-per-pixel")
        self.synchronous_mode = c.get("synchronous")
        self.max_gpu_cache_memory_mb = c.get("gpu-cache-mem")
        self.max_cpu_cache_memory_mb = c.get("cpu-cache-mem")


class ApplicationParameters(Parameters):
    """Application flags (livre/lib/configuration/
    ApplicationParameters.cpp:63-128)."""

    def __init__(self, argv: Sequence[str] = ()):
        self.data_file_name = ""
        self.animation = 0  # frame delta; 0 = off
        self.animation_fps = 0
        self.animation_follow_data = False
        self.frames: Tuple[int, int] = (0, 0xFFFFFFFF)
        self.max_frames = 0xFFFFFFFF
        self.camera_position = (0.0, 0.0, 1.5)
        self.camera_look_at = (0.0, 0.0, 0.0)
        self.color_map_file = ""
        self.renderer = "bricked"
        super().__init__("Application Parameters")
        if argv:
            self.initialize(argv)

    def _register(self) -> None:
        g = self._group
        add = self.configuration.add_option
        add("volume", "URI of volume data source", "", group=g)
        add(
            "animation",
            "Enable animation mode with optional frame delta",
            0,
            group=g,
            implicit=1,
        )
        add("animation-fps", "Animation frames per second", 0, group=g)
        add(
            "animation-follow-data",
            "Animation follows the latest available frame",
            False,
            group=g,
        )
        add(
            "frames",
            "Frames to render [start end)",
            None,
            type=int,
            group=g,
            n_args=2,
        )
        add("num-frames", "Maximum number of frames to render", 0xFFFFFFFF, group=g)
        add(
            "camera-position",
            "Camera position (x y z)",
            None,
            type=float,
            group=g,
            n_args=3,
        )
        add(
            "camera-lookat",
            "Camera look-at point (x y z)",
            None,
            type=float,
            group=g,
            n_args=3,
        )
        add("colormap", "Path to a transfer-function file", "", group=g)
        add("renderer", "Renderer to use [bricked|shearwarp|xla]", "bricked", group=g)

    def _apply(self) -> None:
        c = self.configuration
        self.data_file_name = c.get("volume")
        self.animation = c.get("animation")
        self.animation_fps = c.get("animation-fps")
        self.animation_follow_data = c.get("animation-follow-data")
        if self.animation_follow_data:
            self.animation = 1  # follow-data implies animation on
        frames = c.get("frames")
        if frames is not None:
            self.frames = (frames[0], frames[1])
        self.max_frames = c.get("num-frames")
        pos = c.get("camera-position")
        if pos is not None:
            self.camera_position = tuple(pos)
        look = c.get("camera-lookat")
        if look is not None:
            self.camera_look_at = tuple(look)
        self.color_map_file = c.get("colormap")
        self.renderer = c.get("renderer")
