"""``host_ms.view``: the mean length of the program's ``libre.scene.render``
span (a ``VolumeScene`` frame's host work; the synchronise that follows is
outside it), in ms."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).mean_ms("libre.scene.render")
