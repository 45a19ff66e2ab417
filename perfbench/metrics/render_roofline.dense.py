"""``render_roofline.dense``: the dense trainer's render against its
roofline, in %: the least time of the window's renders (every view
forward and backward a step, ``driver.launch_bounds("dense")`` from
``work/dense_pre``) over the window's device busy time less the device
time launched inside ``Optimizer.step`` ranges (the update's).  None
where the window kept the device busy with nothing but the update."""


def read(trace, driver):
    bounds = driver.launch_bounds("dense")
    optim_s, _ranges = trace.ranges("Optimizer.step")
    render_s = trace.busy_s - optim_s
    if not bounds or render_s <= 0.0:
        return None
    return 100.0 * sum(bounds) / render_s
