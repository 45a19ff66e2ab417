"""`livre` CLI equivalent: render frames of a volume URI to image files
(``libre_tpu.apps.render_cli``).

Reference: apps/livre/livre.cpp:56-96 (argument parsing + client frame
loop), with the animation/frame-range semantics of Config::frame
(livre/eq/Config.cpp:329-372) driven by FrameUtils.

    python -m libre_tpu_torch.apps.render_cli \\
        --volume "mem://#512,512,512,32?pattern=gradient" -o out

``--device`` picks the torch device (default ``cuda``); ``-o`` is short
for ``--output-dir``.  ``--mesh RxB`` shards bricked frames over a (ray ×
brick) mesh of ``--mesh-devices`` (default: every CUDA device, or the CPU
repeated R·B times with ``--device cpu``; a device may repeat), ``--mesh
auto`` over every device (two on the brick axis when their count is even).
In a multi-process launch (``parallel.distributed.initialize`` called
first) the controller's camera is broadcast to every process.  Exits with
the frames-per-second summary the reference logs at client exit
(Client.cpp:239-243).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import numpy as np


def build_camera(width, height, position, look_at_point, near=0.1, far=15.0):
    """Camera + frustum looking from ``position`` at ``look_at_point``,
    with `up` nudged near the poles to avoid gimbal lock
    (CameraSettings.cpp:setCameraLookAt)."""
    from libre_tpu_torch.core.frustum import Frustum, look_at, perspective
    from libre_tpu_torch.ops.reference import Camera

    eye = np.asarray(position, np.float32)
    z_axis = eye.astype(np.float64) - np.asarray(look_at_point, np.float64)
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
    mv = look_at(eye, look_at_point, up).astype(np.float32)
    proj = perspective(50.0, width / height, near, far)
    frustum = Frustum(mv, proj)
    camera = Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, width, height),
        near=frustum.near,
    )
    return camera, frustum


def _mesh(arg: str, devices: str, device):
    """The ``--mesh`` of ``arg`` over ``devices`` (comma-separated), or
    None without ``arg``."""
    from libre_tpu_torch.parallel.mesh import local_devices, parse_mesh

    if not arg:
        return None
    if devices:
        devs = [d.strip() for d in devices.split(",") if d.strip()]
    elif device.type == "cpu":
        n = 1 if arg == "auto" else int(np.prod([int(x) for x in arg.lower().split("x")]))
        devs = ["cpu"] * n
    else:
        devs = local_devices()
    return parse_mesh(arg, devs)


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from libre_tpu_torch.parallel import distributed

    from libre_tpu_torch.core.config import ApplicationParameters, RendererParameters
    from libre_tpu_torch.core.frame_utils import FrameUtils
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.utils.image import write_image
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.ops.transfer_function import load_1dt
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.render.registry import create_renderer

    argv = list(sys.argv[1:] if argv is None else argv)
    # `-o DIR` is short for `--output-dir DIR`.
    argv = ["--output-dir" if a == "-o" else a for a in argv]
    extra = [
        ("width", "Image width", 512),
        ("height", "Image height", 512),
        ("output-dir", "Output directory for frames", "."),
        ("format", "Image format [png|jpg]", "png"),
        ("device", "Torch device to render on", "cuda"),
        ("mesh", "Device mesh RxB (ray x brick axes, e.g. 2x2) or 'auto' for "
         "all devices; routes bricked frames through the sharded renderer", ""),
        ("mesh-devices", "Comma-separated devices of the mesh, ray-major (a "
         "device may repeat); default every CUDA device", ""),
    ]
    app = ApplicationParameters()
    vr = RendererParameters()
    for name, desc, default in extra:
        app.configuration.add_option(name, desc, default, group="Output")
    rest = app.initialize(argv)
    rest = vr.initialize(rest)
    if rest and ("--help" in rest or "-h" in rest):
        print(app.configuration.help_text())
        print(vr.configuration.help_text())
        return 0
    if rest:
        print(f"unknown arguments: {rest}", file=sys.stderr)
        return 2
    if not app.data_file_name:
        print("--volume URI is required (e.g. mem://#64,64,64,16)", file=sys.stderr)
        return 2

    width = app.configuration.get("width")
    height = app.configuration.get("height")
    out_dir = app.configuration.get("output-dir")
    fmt = app.configuration.get("format")
    device = torch.device(app.configuration.get("device"))
    os.makedirs(out_dir, exist_ok=True)

    load_plugins()
    renderer = create_renderer(app.renderer)
    mesh = _mesh(
        str(app.configuration.get("mesh") or ""),
        str(app.configuration.get("mesh-devices") or ""), device,
    )
    if mesh is not None:
        print(f"mesh: {mesh.shape} on {[str(d) for d in mesh.distinct_devices()]}")
    engine = RenderEngine(
        DataSource(app.data_file_name),
        max_gpu_cache_mb=vr.max_gpu_cache_memory_mb,
        max_cpu_cache_mb=vr.max_cpu_cache_memory_mb,
        filter_mode="trilinear",
        device=device,
        mesh=mesh,
    )
    info = engine.info

    camera, frustum = build_camera(
        width, height, app.camera_position, app.camera_look_at
    )
    # Multi-process launches: every process parses the same arguments,
    # but the camera is committed by the controller and synced to all —
    # the FrameData commit/sync cycle (FrameData.h:32-147).
    if distributed.process_count() > 1:
        camera, frustum = distributed.broadcast_frame_state((camera, frustum))
    if app.color_map_file:
        engine.transfer_function = torch.from_numpy(
            load_1dt(app.color_map_file)
        ).to(device)

    params = None
    if vr.samples_per_ray > 0:
        params = RenderParams(
            n_samples_per_ray=vr.samples_per_ray,
            samples_per_pixel=vr.samples_per_pixel,
            data_source_range=engine.data_source_range,
            filter_mode="trilinear",
        )

    fu = FrameUtils(app.frames, tuple(info.frame_range))
    frame = fu.get_current(app.frames[0])
    delta = app.animation if app.animation else 1
    n_frames = min(
        app.max_frames,
        (fu.frame_range[1] - fu.frame_range[0]) if fu.is_valid else 1,
    )
    if not app.animation:
        n_frames = min(n_frames, 1)

    t0 = time.perf_counter()
    rendered = 0
    for _ in range(n_frames):
        ts = int(frame) if fu.is_valid else 0
        if app.renderer == "shearwarp":
            # The pre-classified sweep over one dense LOD level.
            level = min(vr.max_lod, info.root_node.depth - 1)
            img = renderer.render(
                engine,
                camera,
                frustum,
                params=params,
                level=level,
                time_step=ts,
                n_planes=vr.samples_per_ray or None,
            )
            detail = f"shearwarp level {level}"
        else:
            img = renderer.render(
                engine,
                camera,
                frustum,
                params=params,
                screen_space_error=vr.screen_space_error,
                min_lod=vr.min_lod,
                max_lod=vr.max_lod,
                time_step=ts,
                synchronous=True,
            )
            detail = f"{app.renderer} renderer"
        path = os.path.join(out_dir, f"frame_{frame:06d}.{fmt}")
        write_image(path, img.cpu().numpy())
        rendered += 1
        print(f"frame {frame}: {detail} on {device} -> {path}")
        if fu.is_valid:
            frame = fu.get_next(frame, delta)

    dt = time.perf_counter() - t0
    # FPS summary at exit (Client.cpp:239-243).
    print(f"{rendered} frames in {dt:.2f} s = {rendered / dt:.2f} FPS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
