"""The device's idle share of the window, in %: 1 − the union of its
kernels', copies' and memsets' intervals over the window's length."""


def read(trace, driver):
    if trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
