"""``host_idle_ms.view``: the device's idle ms a frame that fall under an
open ``libre.*`` span, per ``libre.scene.render``; the split by span goes
to standard error."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).idle_ms("libre.scene.render")
