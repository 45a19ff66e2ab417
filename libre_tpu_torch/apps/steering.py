"""Remote steering bridge: HTTP endpoints for camera / transfer function /
clip planes / renderer parameters / frame grabs.

Reference: the ZeroEQ Communicator (livre/eq/zeroeq/communicator.cpp) —
zeromq pub/sub of LookOut/ColorMap/Histogram plus an HTTP server exposing
exit, ImageJPEG (render-and-grab, Config::renderJPEG, Config.cpp:222-247),
camera get/set and parameters (communicator.cpp:204-272).  The
framework keeps the out-of-band steering side channel as plain JSON/HTTP
(SURVEY.md §5.8); the GUI equivalent is any HTTP client.

Endpoints (JSON unless noted):
    GET  /                -> the web steering UI (webui.html; the
                             livreGUI equivalent: TF curve editor w/
                             histogram, camera orbit, params, clipping)
    GET  /colormap        -> {"rgba": [[r,g,b,a] x 256]}
    GET  /camera          -> {"modelview": [[...]]}
    PUT  /camera          <- {"modelview": ...} or {"position": ..,
                             "lookat": ..}
    PUT  /colormap        <- {"rgba": [[r,g,b,a] x N]}
    PUT  /clip-planes     <- {"planes": [[nx,ny,nz,d] x <=6]}
    GET  /params          -> renderer parameters
    PUT  /params          <- any subset of the parameters
    GET  /histogram       -> {"bins": [...], "min": .., "max": ..}
    GET  /frame           -> {"frame_number": ..}
    PUT  /frame           <- {"frame_number": ..}
    POST /image-jpeg      -> image/jpeg body (render + grab)
    POST /exit
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from libre_tpu_torch.core.settings import FrameData


class SteeringServer:
    """Wraps a FrameData (the replicated steering state) + callbacks."""

    def __init__(
        self,
        frame_data: FrameData,
        host: str = "127.0.0.1",
        port: int = 0,
        render_jpeg: Optional[Callable[[], bytes]] = None,
        get_histogram: Optional[Callable[[], Optional[dict]]] = None,
        get_statistics: Optional[Callable[[], Optional[dict]]] = None,
        on_change: Optional[Callable[[], None]] = None,
        on_exit: Optional[Callable[[], None]] = None,
        get_layout: Optional[Callable[[], dict]] = None,
        set_layout: Optional[Callable[[dict], dict]] = None,
    ):
        self.frame_data = frame_data
        self._render_jpeg = render_jpeg
        self._get_histogram = get_histogram
        self._get_statistics = get_statistics
        self._on_change = on_change or (lambda: None)
        self._on_exit = on_exit or (lambda: None)
        self._get_layout = get_layout
        self._set_layout = set_layout
        self._params: dict = {
            "sse": 4.0,
            "min_lod": 0,
            "max_lod": 15,
            "samples_per_ray": 0,
            "samples_per_pixel": 1,
            "synchronous": False,
        }
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def do_GET(self):
                fd = outer.frame_data
                if self.path in ("/", "/ui", "/index.html"):
                    # The web steering surface (livreGUI equivalent,
                    # apps/livreGUI/transferFunctionEditor/
                    # TransferFunctionEditor.cpp:95-188 + pointer
                    # handler + parameter controllers as one page).
                    import os

                    path = os.path.join(
                        os.path.dirname(os.path.abspath(__file__)),
                        "webui.html",
                    )
                    with open(path, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/colormap":
                    self._json(
                        {
                            "rgba": np.asarray(
                                fd.render_settings.color_map, np.float32
                            ).tolist()
                        }
                    )
                elif self.path == "/camera":
                    self._json(
                        {
                            "modelview": np.asarray(
                                fd.camera_settings.get_modelview_matrix()
                            ).tolist()
                        }
                    )
                elif self.path == "/params":
                    self._json(outer._params)
                elif self.path == "/frame":
                    self._json({"frame_number": fd.frame_settings.frame_number})
                elif self.path == "/histogram":
                    h = outer._get_histogram() if outer._get_histogram else None
                    self._json(h or {})
                elif self.path == "/layout":
                    # Active multi-view layout + the available cycle
                    # (Config::switchLayout, 'l' key semantics).
                    g = outer._get_layout() if outer._get_layout else None
                    self._json(g or {})
                elif self.path == "/statistics":
                    # cache/render counters (the Channel statistics
                    # overlay, Channel.cpp:342-436, as JSON)
                    s = (
                        outer._get_statistics()
                        if outer._get_statistics
                        else None
                    )
                    self._json(s or {})
                else:
                    self._json({"error": "not found"}, 404)

            def do_PUT(self):
                fd = outer.frame_data
                try:
                    body = self._body()
                except Exception:
                    self._json({"error": "bad json"}, 400)
                    return
                if self.path == "/camera":
                    if "modelview" in body:
                        fd.camera_settings.set_modelview_matrix(
                            np.asarray(body["modelview"], np.float32)
                        )
                    if "position" in body:
                        fd.camera_settings.set_camera_position(body["position"])
                    if "lookat" in body:
                        fd.camera_settings.set_camera_look_at(body["lookat"])
                elif self.path == "/colormap":
                    fd.render_settings.color_map = np.asarray(
                        body["rgba"], np.float32
                    )
                elif self.path == "/clip-planes":
                    from libre_tpu_torch.core.clip_planes import ClipPlanes

                    fd.render_settings.clip_planes = ClipPlanes(body["planes"])
                elif self.path == "/params":
                    outer._params.update(body)
                elif self.path == "/frame":
                    fd.frame_settings.frame_number = int(body["frame_number"])
                elif self.path == "/layout":
                    if outer._set_layout is None:
                        self._json({"error": "no layouts"}, 503)
                        return
                    out = outer._set_layout(body)
                    outer._on_change()
                    self._json(out)
                    return
                else:
                    self._json({"error": "not found"}, 404)
                    return
                outer._on_change()
                self._json({"ok": True})

            def do_POST(self):
                # Read the request's body even where it is unused: a
                # socket closed with unread input resets the connection,
                # and the client can lose the response it is reading.
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.path == "/image-jpeg":
                    if outer._render_jpeg is None:
                        self._json({"error": "no renderer attached"}, 503)
                        return
                    data = outer._render_jpeg()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/exit":
                    self._json({"ok": True})
                    outer._on_exit()
                    threading.Thread(target=outer.stop, daemon=True).start()
                else:
                    self._json({"error": "not found"}, 404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def params(self) -> dict:
        return self._params

    @property
    def address(self):
        return self._server.server_address

    def start(self) -> "SteeringServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()
