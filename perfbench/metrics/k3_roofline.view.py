"""``k3_roofline.view``: K3's share of its roofline over the window, in % (the
kernels named ``exact_march_kernel``)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k3", "exact_march_kernel")
