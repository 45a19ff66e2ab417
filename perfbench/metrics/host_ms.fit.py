"""``host_ms.fit``: the mean length of the program's ``libre.train.step``
span (the trainers' step, up to the return of the detached loss; the
loss read that follows it is outside it), in ms."""

from perfbench import spans


def read(trace, driver):
    return spans.of(trace).mean_ms("libre.train.step")
