"""Run one cell of ``BENCHMARK.json`` once on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (or ``python -m perfbench.run ...``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number the check compared,
with its limit, also printed as the last lines of standard error.  Exits
non-zero and prints no result without a CUDA device (or fewer than the
cell asks for), when the program cannot be imported, or when ``jax``,
``jaxlib``, ``flax`` or ``libre_tpu`` is loaded once the window has
closed."""

import time

STARTED = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from perfbench.harness import RunError, forbidden_modules, run

    try:
        result = run(sys.argv[1:] if argv is None else argv, ROOT, STARTED)
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 1
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 1
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
