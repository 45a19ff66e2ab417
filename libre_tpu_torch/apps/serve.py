"""Interactive render service: engine + steering server + frame loop
(``libre_tpu.apps.serve``).

The app-node Client/Config loop of the reference (livre/eq/Client.cpp:
146-258, Config.cpp:329-372) reduced to its core: a RenderEngine owns the
data/atlas/caches, a SteeringServer exposes the FrameData over HTTP, and
the frame loop renders when steering events invalidate the image (the
REDRAW event path) or animation advances.

    python -m libre_tpu_torch.apps.serve --volume mem://#64,64,64,16 \\
        --port 8080 --width 512 --height 512

Then:  curl -X PUT -d '{"position": [0,0,2]}' localhost:8080/camera
       curl -X POST localhost:8080/image-jpeg > frame.jpg
       curl -X POST localhost:8080/exit

``--device`` picks the torch device (default ``cuda``).  A multi-view
layout of synchronous ``bricked`` frames renders through the engine's
wall (one device canvas); other layouts render their views one after
another.  The views of a layout share the engine's cached stores and
frame runners.  With more
than one CUDA device (``mesh="auto"``) or an explicit ``Mesh``, bricked
frames shard over the mesh (``RenderEngine.render_bricked_sharded``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional

import numpy as np


class RenderService:
    """Wires FrameData + engine + steering into a render-on-demand loop."""

    def __init__(
        self,
        volume_uri: str,
        width: int = 512,
        height: int = 512,
        host: str = "127.0.0.1",
        port: int = 0,
        max_gpu_cache_mb: int = 3072,
        max_cpu_cache_mb: int = 8192,
        renderer: str = "bricked",
        mesh="auto",
        device="cuda",
    ):
        from libre_tpu_torch.apps.steering import SteeringServer
        import torch

        from libre_tpu_torch.core.frustum import perspective
        from libre_tpu_torch.core.settings import FrameData
        from libre_tpu_torch.data.datasource import DataSource, load_plugins
        from libre_tpu_torch.parallel.mesh import local_devices, parse_mesh, require_mesh
        from libre_tpu_torch.render.engine import RenderEngine

        # Auto-meshing: with more than one CUDA device, interactive frames
        # shard over a (ray x brick) mesh, as the reference's eq deployment
        # launches one channel per GPU (Client.cpp:146-258); with one
        # device (or on the CPU) there is no mesh.  An explicit Mesh
        # shards the bricked frames over its devices.
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"RenderService: mesh={mesh!r}, expected 'auto', None or a Mesh")
            devices = local_devices() if torch.device(device).type == "cuda" else ()
            mesh = parse_mesh("auto", devices) if len(devices) > 1 else None
        elif mesh is not None:
            require_mesh("RenderService", mesh)
        load_plugins()
        self.width, self.height = width, height
        # "bricked": the store sweep over the atlas (interactive default;
        # a steady frame is one sweep and the warp).  "exact": the
        # engine's exact perspective march.
        self.renderer = renderer
        self.engine = RenderEngine(
            DataSource(volume_uri),
            max_gpu_cache_mb=max_gpu_cache_mb,
            max_cpu_cache_mb=max_cpu_cache_mb,
            filter_mode="trilinear",
            device=device,
            mesh=mesh,
        )
        self.frame_data = FrameData()
        self.frame_data.volume_settings.uri = volume_uri
        self.frame_data.camera_settings.set_camera_position([0.0, 0.0, 1.5])
        self.frame_data.camera_settings.set_camera_look_at([0.0, 0.0, 0.0])
        self._proj = perspective(50.0, width / height, 0.1, 15.0)
        self._dirty = threading.Event()
        self._dirty.set()
        self._running = True
        self._frames_rendered = 0
        # Multi-view layouts (Config::switchLayout, Config.cpp:394-491;
        # 'l' cycles): named wall arrangements of simultaneous views of
        # the one volume, each an orbit of the steered camera.
        self.layouts = ["single", "1x2", "2x2"]
        self.layout = "single"
        self._histogram: Optional[dict] = None

        self.server = SteeringServer(
            self.frame_data,
            host=host,
            port=port,
            render_jpeg=self.render_jpeg,
            get_histogram=lambda: self._histogram,
            get_statistics=self.statistics,
            on_change=self._dirty.set,
            on_exit=self.stop,
            get_layout=lambda: {
                "layout": self.layout,
                "layouts": self.layouts,
            },
            set_layout=self._set_layout,
        )

    def _set_layout(self, body: dict) -> dict:
        """PUT /layout {"name": ...} selects; {"cycle": ±1} steps
        through the layout list ('l'/'L' keys,
        KeyboardHandler.cpp:80-86)."""
        if "name" in body:
            if body["name"] not in self.layouts:
                return {"error": f"unknown layout {body['name']}"}
            self.layout = body["name"]
        elif "cycle" in body:
            i = self.layouts.index(self.layout)
            self.layout = self.layouts[
                (i + int(body["cycle"])) % len(self.layouts)
            ]
        return {"layout": self.layout, "layouts": self.layouts}

    def statistics(self) -> dict:
        """Cache/render counters for the /statistics endpoint (the
        Channel statistics overlay, Channel.cpp:342-436)."""
        def cache(c):
            s = c.statistics
            return {
                "hits": s.hits,
                "misses": s.misses,
                "objects": s.object_count,
                "used_bytes": s.used_bytes,
                "max_bytes": s.max_bytes,
            }

        return {
            "data_cache": cache(self.engine.data_cache),
            "texture_cache": cache(self.engine.texture_cache),
            "frames_rendered": self._frames_rendered,
        }

    # ----------------------------------------------------------- render
    def _render_once(self, camera, frustum, kw, renderer):
        """One engine frame; returns (image, stats, histogram).  The
        histogram comes from the rendering set the frame composites."""
        if renderer == "bricked":
            img, stats = self.engine.render_bricked(
                camera, frustum, collect_histogram=True, **kw
            )
            hist = stats.histogram
        else:
            img, stats, hist = self.engine.render(
                camera, frustum, collect_histogram=True, **kw
            )
        return img, stats, hist

    def _schedule_redraw(self, futures) -> None:
        """Arm the redraw: when the async uploads land, mark the frame
        dirty so the run loop re-renders with the new bricks — the
        RedrawFilter → REDRAW event of the reference
        (GLRaycastPipeline.cpp:241-308, Channel.cpp:64-90)."""
        if not futures:
            self._dirty.set()
            return
        remaining = [len(futures)]
        lock = threading.Lock()

        def landed(_future):
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    self._dirty.set()

        for f in futures:
            f.add_done_callback(landed)

    def _layout_views(self):
        """(dx, dy, w, h, azimuth°) tiles of the active layout."""
        w, h = self.width, self.height
        if self.layout == "1x2":
            return [
                (0, 0, w // 2, h, 0.0),
                (w // 2, 0, w - w // 2, h, 180.0),
            ]
        if self.layout == "2x2":
            w2, h2 = w // 2, h // 2
            return [
                (0, 0, w2, h2, 0.0),
                (w2, 0, w - w2, h2, 90.0),
                (0, h2, w2, h - h2, 180.0),
                (w2, h2, w - w2, h - h2, 270.0),
            ]
        return [(0, 0, w, h, 0.0)]

    def view_camera(self, vw: int, vh: int, azimuth: float):
        """(camera, frustum) of one layout view: the steered modelview
        orbited by ``azimuth`` degrees about y, at the view's size."""
        from libre_tpu_torch.core.frustum import Frustum, perspective
        from libre_tpu_torch.ops.reference import Camera

        mv0 = self.frame_data.camera_settings.get_modelview_matrix()
        rad = np.deg2rad(azimuth)
        c, s = np.cos(rad), np.sin(rad)
        rot = np.array(
            [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
            np.float32,
        )
        mv = (mv0.astype(np.float64) @ rot.astype(np.float64)).astype(np.float32)
        proj = (
            self._proj
            if (vw, vh) == (self.width, self.height)
            else perspective(50.0, vw / vh, 0.1, 15.0)
        )
        frustum = Frustum(mv, proj)
        camera = Camera(
            inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
            inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
            viewport=(0, 0, vw, vh),
            near=frustum.near,
        )
        return camera, frustum

    def frame_keywords(self) -> dict:
        """The engine keywords of the current FrameData and parameters."""
        fd = self.frame_data
        p = self.server.params
        frame = fd.frame_settings.frame_number
        return dict(
            screen_space_error=float(p.get("sse", 4.0)),
            min_lod=int(p.get("min_lod", 0)),
            max_lod=min(
                int(p.get("max_lod", 15)), fd.render_settings.max_tree_depth
            ),
            clip_planes=fd.render_settings.clip_planes
            if fd.render_settings.clip_planes.planes
            else None,
            time_step=0 if frame == 0xFFFFFFFF else frame,
            synchronous=bool(p.get("synchronous", True)),
        )

    def render_frame(self, progressive: bool = False) -> np.ndarray:
        """Render the current FrameData state under the active layout.

        Default (grab/snapshot semantics, Config::renderJPEG,
        Config.cpp:222-247): in asynchronous mode, iterate
        render → wait-for-uploads until rendering_done — the converged
        image a single reference frame+redraw cycle would eventually
        show.  ``progressive=True`` (the interactive run loop) renders
        whatever is resident NOW and schedules a redraw when the kicked
        uploads land (progressive refinement, renderAsync semantics).

        Non-single layouts render N orbit views of the one volume into
        one canvas (the reference's multi-view walls, Config.cpp:394-491),
        every view on the engine's cached stores and runners.  With the
        ``bricked`` renderer and synchronous frames they go through the
        engine's wall (``plan_wall``, then ``draw_wall``: one device
        canvas, copied to the host once; the histogram that of view 0's
        rendering set), as the JAX service's (``libre_tpu/apps/serve.py:
        270-310``), unless a view fails the wall's tests (an empty set, a
        store off the single-store path), tested before the wall renders;
        otherwise view by view, each view copied to the host.  The
        histogram is view 0's."""
        import torch

        self.engine.transfer_function = torch.as_tensor(
            np.asarray(self.frame_data.render_settings.color_map, np.float32),
            device=self.engine.device,
        )
        kw = self.frame_keywords()
        renderer = self.server.params.get("renderer", self.renderer)
        views = self._layout_views()

        wall = None
        if len(views) > 1 and renderer == "bricked" and kw["synchronous"]:
            wall_views = [
                (*self.view_camera(vw, vh, az), (dx, dy)) for dx, dy, vw, vh, az in views
            ]
            wkw = {k: v for k, v in kw.items() if k != "synchronous"}
            plan, why = self.engine.plan_wall(wall_views, (self.height, self.width), **wkw)
            if why is None:
                wall = self.engine.draw_wall(
                    plan, (self.height, self.width), wkw["clip_planes"], wkw["time_step"]
                )[0]
                hist0 = self.engine.accumulate_histogram(plan[0].nodes)
        if wall is not None:
            canvas = wall.cpu().numpy()
        else:
            canvas = np.zeros((self.height, self.width, 4), np.float32)
            hist0 = None
            for vi, (dx, dy, vw, vh, az) in enumerate(views):
                camera, frustum = self.view_camera(vw, vh, az)
                img, hist = self._render_view(camera, frustum, kw, renderer, progressive)
                canvas[dy : dy + vh, dx : dx + vw] = img.cpu().numpy()
                if vi == 0:
                    hist0 = hist
        if hist0 is not None:
            self._histogram = {
                "bins": np.asarray(hist0.bins).tolist(),
                "min": float(hist0.min_value),
                "max": float(hist0.max_value),
            }
        return canvas

    def _render_view(self, camera, frustum, kw, renderer, progressive):
        img, stats, hist = self._render_once(camera, frustum, kw, renderer)
        if not stats.rendering_done:
            if progressive:
                self._schedule_redraw(stats.pending_uploads)
            else:
                # Converge in place: each round blocks on the uploads the
                # previous render kicked, then re-renders; bounded by the
                # tree depth (each round promotes at least one LOD level
                # into residency).
                for _ in range(32):
                    pending = stats.pending_uploads
                    for f in pending:
                        f.result()
                    img, stats, hist = self._render_once(
                        camera, frustum, kw, renderer
                    )
                    if stats.rendering_done:
                        break
                    if not pending and not stats.pending_uploads:
                        # No uploads in flight and none kicked: another
                        # round cannot make progress (e.g. a brick that
                        # permanently fails to load).
                        break
                if not stats.rendering_done:
                    print(
                        "render_frame: returning before convergence "
                        f"(nodes not resident: {stats.n_not_available})",
                        file=sys.stderr,
                        flush=True,
                    )
        return img, hist

    def render_jpeg(self) -> bytes:
        from libre_tpu_torch.utils.image import encode_jpeg

        return encode_jpeg(self.render_frame())

    # ------------------------------------------------------------- loop
    def run(self, max_frames: Optional[int] = None) -> int:
        from libre_tpu_torch.core.frame_utils import FrameUtils

        self.server.start()
        host, port = self.server.address
        print(f"steering server on http://{host}:{port}", flush=True)
        rendered = 0
        last_anim = time.perf_counter()
        while self._running and (max_frames is None or rendered < max_frames):
            # Animation: advance the time step at animation_fps and mark
            # the frame dirty (the AnimationController loop,
            # apps/livreGUI/animationController + Config::frame).
            p = self.server.params
            delta = int(p.get("animation", 0))
            if delta:
                fps = max(float(p.get("animation_fps", 10.0)), 0.1)
                now = time.perf_counter()
                if now - last_anim >= 1.0 / fps:
                    last_anim = now
                    fr = self.engine.info.frame_range
                    fu = FrameUtils(
                        (int(fr[0]), int(fr[1])), (int(fr[0]), int(fr[1]))
                    )
                    cur = self.frame_data.frame_settings.frame_number
                    cur = fu.get_current(cur)
                    self.frame_data.frame_settings.frame_number = (
                        fu.get_next(cur, delta)
                    )
                    self._dirty.set()
            if not self._dirty.wait(timeout=0.05 if delta else 0.25):
                continue
            self._dirty.clear()
            t0 = time.perf_counter()
            self.render_frame(progressive=True)
            rendered += 1
            self._frames_rendered = rendered
            print(
                f"frame {rendered} rendered in "
                f"{time.perf_counter() - t0:.2f} s",
                flush=True,
            )
        return rendered

    def stop(self) -> None:
        self._running = False
        self._dirty.set()


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Interactive render service")
    p.add_argument("--volume", required=True)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument(
        "--renderer", default="bricked", choices=["bricked", "exact"],
        help="bricked = store sweep over the atlas (default); exact = "
        "the exact march",
    )
    p.add_argument("--device", default="cuda", help="torch device to render on")
    args = p.parse_args(argv)
    service = RenderService(
        args.volume, args.width, args.height, args.host, args.port,
        renderer=args.renderer, device=args.device,
    )
    service.run(args.max_frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
