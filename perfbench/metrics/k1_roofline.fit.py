"""``k1_roofline.fit``: K1's share of its roofline over the window, in % (the
kernels named ``post_sweep_kernel``)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k1", "post_sweep_kernel")
