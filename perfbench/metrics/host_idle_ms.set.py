"""``host_idle_ms.set``: the device's idle ms a step of the mesh trainer
that fall under an open ``libre.*`` span, on any thread, per
``libre.train.step``; the split by span goes to standard error."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).idle_ms("libre.train.step")
