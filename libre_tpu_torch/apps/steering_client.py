"""Steering client CLI — the livreGUI equivalent over plain HTTP.

The reference GUI (apps/livreGUI/, Qt over ZeroEQ) steers a running
renderer: camera, transfer-function editing + load/save (.1dt files),
animation frame control, clip planes, renderer parameters, progress.
This client drives the same controls against a
:mod:`libre_tpu_torch.apps.serve` instance:

    python -m libre_tpu_torch.apps.steering_client --url http://localhost:8080 \\
        camera --position 0 0 2
    ... colormap --file warm.1dt
    ... colormap --preset default
    ... clip --plane 1 0 0 0.25
    ... params --sse 1.0 --max-lod 3
    ... frame --number 7
    ... grab --output shot.jpg
    ... histogram
    ... exit
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request
from typing import Optional


def _call(url: str, method: str = "GET", body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=600) as resp:
        raw = resp.read()
        if "json" in resp.headers.get("Content-Type", ""):
            return json.loads(raw)
        return raw


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="Steer a running render service")
    p.add_argument("--url", default="http://127.0.0.1:8080")
    sub = p.add_subparsers(dest="cmd", required=True)

    cam = sub.add_parser("camera", help="get/set the camera")
    cam.add_argument("--position", nargs=3, type=float)
    cam.add_argument("--lookat", nargs=3, type=float)

    cm = sub.add_parser("colormap", help="push a transfer function")
    cm.add_argument("--file", help=".1dt / .lba / .lbb transfer function file")
    cm.add_argument("--preset", choices=["default", "grayscale"])
    cm.add_argument(
        "--point",
        nargs=3,
        action="append",
        default=[],
        metavar=("CHANNEL", "X", "Y"),
        help="control point edit, e.g. --point alpha 0.5 0.9 "
        "(TransferFunctionEditor HoverPoints equivalent); starts from "
        "--file/--preset and may repeat",
    )
    cm.add_argument("--save", help="also save the result (.lba/.lbb/.1dt)")

    clip = sub.add_parser("clip", help="set clip planes")
    clip.add_argument(
        "--plane", nargs=4, type=float, action="append", default=[]
    )
    clip.add_argument("--clear", action="store_true")

    par = sub.add_parser("params", help="get/set renderer parameters")
    par.add_argument("--sse", type=float)
    par.add_argument("--min-lod", type=int)
    par.add_argument("--max-lod", type=int)
    par.add_argument("--samples-per-ray", type=int)

    fr = sub.add_parser("frame", help="get/set the animation frame")
    fr.add_argument("--number", type=int)

    grab = sub.add_parser("grab", help="render + save a JPEG")
    grab.add_argument("--output", default="frame.jpg")

    lay = sub.add_parser(
        "layout", help="get/set the multi-view layout ('l' key semantics)"
    )
    lay.add_argument("--name", choices=["single", "1x2", "2x2"])
    lay.add_argument("--cycle", type=int, help="step ±N through layouts")

    sub.add_parser("histogram", help="fetch the current histogram")
    sub.add_parser("stats", help="fetch cache/render statistics")
    sub.add_parser("exit", help="shut the service down")

    args = p.parse_args(argv)
    base = args.url.rstrip("/")

    if args.cmd == "camera":
        body = {}
        if args.position:
            body["position"] = args.position
        if args.lookat:
            body["lookat"] = args.lookat
        if body:
            _call(f"{base}/camera", "PUT", body)
        print(json.dumps(_call(f"{base}/camera"), indent=2))
    elif args.cmd == "colormap":
        from libre_tpu_torch.ops import colormap as cm_ops
        from libre_tpu_torch.ops.transfer_function import (
            grayscale_ramp, save_1dt,
        )

        if args.file:
            table = cm_ops.load(args.file)
        elif args.preset == "grayscale":
            table = grayscale_ramp()
        else:
            table = cm_ops.ColorMap.default().sample()
        if args.point:
            cmap = cm_ops.ColorMap.from_table(table)
            for ch, x, y in args.point:
                cmap.add_point(ch, float(x), float(y))
            table = cmap.sample()
        if args.save:
            if args.save.endswith(".lba"):
                cm_ops.ColorMap.from_table(table).save_lba(args.save)
            elif args.save.endswith(".lbb"):
                cm_ops.ColorMap.from_table(table).save_lbb(args.save)
            else:
                save_1dt(args.save, table)
        rgba = table.tolist()
        print(_call(f"{base}/colormap", "PUT", {"rgba": rgba}))
    elif args.cmd == "clip":
        planes = [] if args.clear else args.plane
        print(_call(f"{base}/clip-planes", "PUT", {"planes": planes}))
    elif args.cmd == "params":
        body = {}
        if args.sse is not None:
            body["sse"] = args.sse
        if args.min_lod is not None:
            body["min_lod"] = args.min_lod
        if args.max_lod is not None:
            body["max_lod"] = args.max_lod
        if args.samples_per_ray is not None:
            body["samples_per_ray"] = args.samples_per_ray
        if body:
            _call(f"{base}/params", "PUT", body)
        print(json.dumps(_call(f"{base}/params"), indent=2))
    elif args.cmd == "layout":
        body = {}
        if args.name:
            body["name"] = args.name
        if args.cycle is not None:
            body["cycle"] = args.cycle
        if body:
            print(json.dumps(_call(f"{base}/layout", "PUT", body), indent=2))
        else:
            print(json.dumps(_call(f"{base}/layout"), indent=2))
    elif args.cmd == "frame":
        if args.number is not None:
            _call(f"{base}/frame", "PUT", {"frame_number": args.number})
        print(json.dumps(_call(f"{base}/frame")))
    elif args.cmd == "grab":
        data = _call(f"{base}/image-jpeg", "POST", {})
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"wrote {args.output} ({len(data)} bytes)")
    elif args.cmd == "histogram":
        print(json.dumps(_call(f"{base}/histogram")))
    elif args.cmd == "stats":
        print(json.dumps(_call(f"{base}/statistics"), indent=2))
    elif args.cmd == "exit":
        print(_call(f"{base}/exit", "POST", {}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
