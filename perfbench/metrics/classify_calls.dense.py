"""``classify_calls.dense``: the dense render's classifications a step
(``shearwarp.precompute_classified_volume.calls``, a program counter: one
a view in "pre"), counted by the driver over the window; None where the
program has no such counter."""


def read(trace, driver):
    return getattr(driver, "classify_calls", None)
