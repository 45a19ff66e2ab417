"""``launches.view``: kernels, copies and memsets a frame launched inside
``libre.scene.render``, matched by CUPTI correlation."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).launches("libre.scene.render")
