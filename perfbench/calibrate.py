"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size (not run by the benchmark's runs):

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> --faults <m> [--first-seed s]

For each of ``n`` seeds, the numbers of a sound run of the program
against the reference (set-up's checked steps, or for frames the
program's frame of poses drawn from the seed); for the first ``m``
seeds also the precision control (the reference in bfloat16 in the
program's place) and the cell's faults planted in the reference or the
program (half of the batch left out; for frames a pixel altered).  Each
reading is one JSON line; the last line is the summary: per number the
largest sound reading and the least reading of the control and of each
fault."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, root: Path = ROOT) -> dict:
    import numpy as np
    import torch

    from perfbench import check, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2147483000)
    args = p.parse_args(argv)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    mod = harness.load_file(root / "perfbench" / "drivers" / f"{traffic['driver']}.py",
                            "perfbench_driver_" + traffic["driver"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    frames = traffic["driver"] == "scene_view"
    readings = {"sound": [], "control": [], "half_batch": [], "altered": []}

    def emit(kind, seed, numbers, seconds):
        readings[kind].append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, "seconds": seconds, **numbers}), flush=True)

    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        d = mod.Driver(config, traffic, seed, device)
        t = time.perf_counter()
        d.setup()
        if frames:
            rng = np.random.default_rng(seed)
            poses = [int(i) for i in rng.choice(len(d.cameras), traffic["checked_frames"],
                                                replace=False)]
            with torch.no_grad():
                got = [d.scene.render(d.cameras[i]).clone() for i in poses]
            d.release()
            want = d.reference_frames(poses)
            emit("sound", seed, check.frame_numbers(got, want), time.perf_counter() - t)
            if k < args.faults:
                t = time.perf_counter()
                emit("control", seed, check.frame_numbers(
                    d.reference_frames(poses, vdt=torch.bfloat16), want), time.perf_counter() - t)
                half = [g.clone() for g in got]
                for h in half:
                    h[: h.shape[0] // 2] = 0.0
                emit("half_batch", seed, check.frame_numbers(half, want), 0.0)
                altered = [g.clone() for g in got]
                altered[0][7, 7] += 0.05
                emit("altered", seed, check.frame_numbers(altered, want), 0.0)
        else:
            d.release()
            want = d.reference()
            emit("sound", seed, check.training_numbers(d.readings, want), time.perf_counter() - t)
            if k < args.faults:
                t = time.perf_counter()
                emit("control", seed, check.training_numbers(d.reference(vdt=torch.bfloat16),
                                                             want), time.perf_counter() - t)
                t = time.perf_counter()
                half = (d.reference(keep_half=True) if traffic["driver"] == "exact_fit"
                        else d.reference(keep=traffic["views"] // 2))
                emit("half_batch", seed, check.training_numbers(half, want),
                     time.perf_counter() - t)
        del d
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {"sound_max": {}, "least": {}}
    for name in readings["sound"][0]:
        summary["sound_max"][name] = max(r[name] for r in readings["sound"])
        summary["least"][name] = {kind: min(r[name] for r in rs)
                                  for kind, rs in readings.items() if kind != "sound" and rs}
    print(json.dumps({"summary": summary}))
    return summary


if __name__ == "__main__":
    main()
