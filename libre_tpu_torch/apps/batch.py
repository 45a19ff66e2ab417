"""Batch renderer: partition a frame range into jobs, skip already-rendered
frames, render locally or emit sbatch scripts.

Reference: apps/livreBatch/livre_batch.py:1-291 — JSON config → sbatch
job scripts, one per frame sub-range; missing-frame detection by globbing
the output directory (that IS the reference's resume story, SURVEY.md
§5.4); frames-per-job rebalancing.  This port adds a ``local`` launcher
(subprocess per range, no SLURM needed on a single GPU host) and keeps the
sbatch generator for clusters.

    python -m libre_tpu_torch.apps.batch --example-config
    python -m libre_tpu_torch.apps.batch -c config.json [--dry-run | --mode local]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import subprocess
import sys
from itertools import groupby
from typing import Dict, List, Tuple

EXAMPLE_JSON = "example.json"

DEFAULT_CONFIG: Dict = {
    "slurm": {
        "job_name": "libre_batch",
        "job_time": "06:00:00",
        "queue": "prod",
        "account": "proj3",
        "output_dir": ".",
        "nodes": 1,
        "tasks_per_node": 1,
    },
    "render": {
        "camera_lookat": "0 0 0",
        "camera_position": "0 0 1",
        "start_frame": 0,
        "end_frame": 100,
        "max_frames": 50,  # frames per job
        "width": 1920,
        "height": 1200,
        "samples_per_ray": 2048,
        "sse": 1,
        "transfer_function": "",
        "volume": "",
        # Watchdog: kill a local render job if it produces no new image
        # for this long (livre_batch.py's idle_timeout; 0 disables).
        "idle_timeout_min": 30,
    },
}


def _run_with_watchdog(cmd: List[str], out_dir: str, idle_timeout_s: float) -> None:
    """Run a render job, killing it if no new output image lands within
    ``idle_timeout_s`` (the reference's crude failure detection,
    livre_batch.py idle-timeout logic — a hung renderer must not pin a
    node for the full job time)."""
    import threading
    import time

    proc = subprocess.Popen(cmd)

    def newest_mtime() -> float:
        try:
            times = [
                e.stat().st_mtime
                for e in os.scandir(out_dir)
                if e.name.startswith("frame_")
            ]
            return max(times) if times else 0.0
        except OSError:
            return 0.0

    def watchdog():
        last = time.time()
        seen = newest_mtime()
        while proc.poll() is None:
            time.sleep(min(5.0, idle_timeout_s / 4))
            now_m = newest_mtime()
            if now_m > seen:
                seen, last = now_m, time.time()
            elif time.time() - last > idle_timeout_s:
                print(
                    f"watchdog: no new frame for {idle_timeout_s:.0f}s, "
                    "killing job", file=sys.stderr,
                )
                proc.kill()
                return

    t = threading.Thread(target=watchdog, daemon=True)
    t.start()
    rc = proc.wait()
    if rc != 0:
        raise subprocess.CalledProcessError(rc, cmd)


def missing_frame_ranges(
    out_dir: str, prefix: str, start: int, end: int
) -> List[Tuple[int, int]]:
    """Half-open [start, end) ranges of frames without an image on disk
    (livre_batch.py submit_jobs missing-frame logic)."""
    files = glob.glob(os.path.join(out_dir, f"{prefix}*.png"))
    found = set()
    for f in files:
        stem = os.path.basename(f)[len(prefix) : -4]
        try:
            found.add(int(stem))
        except ValueError:
            continue
    missing = sorted(set(range(start, end)) - found)
    if not missing:
        return []
    ranges = []
    for _, grp in groupby(enumerate(missing), lambda xy: xy[1] - xy[0]):
        grp = list(grp)
        ranges.append((grp[0][1], grp[-1][1] + 1))
    return ranges


def split_range(start: int, end: int, batch_size: int) -> List[Tuple[int, int]]:
    """Rebalanced frames-per-job split (livre_batch.py
    _submit_jobs_for_range:230-246)."""
    num_frames = end - start
    num_jobs = int(math.ceil(num_frames / batch_size))
    batch = int(math.ceil(num_frames / num_jobs))
    return [(s, min(s + batch, end)) for s in range(start, end, batch)]


def render_args(config: Dict, start: int, end: int) -> List[str]:
    r = config["render"]
    out_dir = config["slurm"]["output_dir"]
    args = [
        "--volume", str(r["volume"]),
        "--sse", str(r["sse"]),
        "--samples-per-ray", str(r["samples_per_ray"]),
        "--animation",
        "--frames", str(start), str(end),
        "--num-frames", str(end - start),
        "--camera-position", *str(r["camera_position"]).split(),
        "--camera-lookat", *str(r["camera_lookat"]).split(),
        "--width", str(r["width"]),
        "--height", str(r["height"]),
        "--output-dir", out_dir,
    ]
    if r.get("transfer_function"):
        args += ["--colormap", str(r["transfer_function"])]
    return args


def build_sbatch_script(config: Dict, start: int, end: int) -> str:
    s = config["slurm"]
    cmd = " ".join(
        [sys.executable, "-m", "libre_tpu_torch.apps.render_cli"]
        + render_args(config, start, end)
    )
    return "\n".join(
        [
            "#!/bin/bash",
            f'#SBATCH --job-name="{s["job_name"]}"',
            f'#SBATCH --time="{s["job_time"]}"',
            f'#SBATCH --partition="{s["queue"]}"',
            f'#SBATCH --account="{s["account"]}"',
            f'#SBATCH --nodes="{s["nodes"]}"',
            f'#SBATCH --ntasks-per-node="{s["tasks_per_node"]}"',
            f'#SBATCH --output="{s["output_dir"]}/%j_out.txt"',
            f'#SBATCH --error="{s["output_dir"]}/%j_err.txt"',
            "",
            cmd,
            "",
        ]
    )


def submit_jobs(config: Dict, mode: str, dry_run: bool, verbose: bool) -> int:
    r = config["render"]
    if not r.get("volume"):
        print("Error: Need valid volume URI", file=sys.stderr)
        return 2
    out_dir = config["slurm"]["output_dir"]
    os.makedirs(out_dir, exist_ok=True)

    ranges = missing_frame_ranges(
        out_dir, "frame_", r["start_frame"], r["end_frame"]
    )
    if not ranges:
        print("No missing frames found, no jobs will be submitted.")
        return 0

    jobs = [
        batch
        for lo, hi in ranges
        for batch in split_range(lo, hi, r["max_frames"])
    ]
    print(f"Create {len(jobs)} job(s)")
    for i, (start, end) in enumerate(jobs, 1):
        print(f"Submit job {i} for frames {start} to {end}...")
        if dry_run:
            if verbose:
                print(build_sbatch_script(config, start, end))
            continue
        if mode == "slurm":
            script = build_sbatch_script(config, start, end)
            proc = subprocess.Popen(["sbatch"], stdin=subprocess.PIPE)
            proc.communicate(input=script.encode())
        else:
            cmd = [
                sys.executable, "-m", "libre_tpu_torch.apps.render_cli"
            ] + render_args(config, start, end)
            idle_min = float(r.get("idle_timeout_min", 0) or 0)
            if idle_min > 0:
                _run_with_watchdog(cmd, out_dir, idle_min * 60.0)
            else:
                subprocess.run(cmd, check=True)
    print(f"{len(jobs)} job(s) {'planned' if dry_run else 'submitted'}, "
          f"outputs in {out_dir}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Submit batch render jobs (SLURM or local)"
    )
    parser.add_argument("-c", "--config", help="path to JSON config file")
    parser.add_argument("--mode", choices=["slurm", "local"], default="local")
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("-e", "--example-config", action="store_true")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.example_config:
        with open(EXAMPLE_JSON, "w") as f:
            json.dump(DEFAULT_CONFIG, f, sort_keys=True, indent=4)
        print(f"Wrote {EXAMPLE_JSON} to current directory")
        return 0
    if not args.config:
        parser.print_help()
        return 2
    with open(args.config) as f:
        config = json.load(f)
    # Merge defaults for missing keys.
    for section, defaults in DEFAULT_CONFIG.items():
        config.setdefault(section, {})
        for k, v in defaults.items():
            config[section].setdefault(k, v)
    return submit_jobs(config, args.mode, args.dry_run, args.verbose)


if __name__ == "__main__":
    sys.exit(main())
