"""``tf_gather_ms.dense``: the device ms a step of the work launched
inside the program's ``libre.tf.take_rows`` and ``libre.tf.take_rows.backward``
spans (``transfer_function._TakeRows``: the TF gathers of the dense
trainer's classification and their ``bincount`` backward, on any thread,
matched by CUPTI correlation), per ``libre.train.step``; None where the
program opens no such span."""

import bisect

from perfbench import spans
from perfbench.trace import _merge

NAMES = ("libre.tf.take_rows", "libre.tf.take_rows.backward")


def read(trace, driver):
    s = spans.of(trace)
    gathers = [ab for name in NAMES for ab in s.named(name)]
    steps = s.named("libre.train.step")
    if not gathers or not steps:
        return None
    corr = set()
    ts = [t for t, _c in trace.launches]
    for a, b in gathers:
        for i in range(bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)):
            corr.add(trace.launches[i][1])
    corr.discard(None)
    busy = _merge([(a, b) for a, b, _n, _cat, c in trace.device if c in corr])
    return sum(b - a for a, b in busy) * 1e-3 / len(steps)
