"""``launches.dense``: kernels, copies and memsets a step of the dense
trainer whose runtime call (matched by CUPTI correlation) was made inside
``libre.train.step``, on any thread."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).launches("libre.train.step")
