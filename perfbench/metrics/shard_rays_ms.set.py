"""``shard_rays_ms.set``: the host ms a step of the sharded render's ray
and box rebuild, the program's ``libre.shard.rays`` spans (the ray pack,
the box rows, the host reads of the boxes and the eye, the moves) summed
over the window per ``libre.train.step``."""

from perfbench import spans


def read(trace, driver):
    s = spans.of(trace)
    rebuilds, steps = s.named("libre.shard.rays"), s.named("libre.train.step")
    if not rebuilds or not steps:
        return None
    return sum(b - a for a, b in rebuilds) * 1e-3 / len(steps)
