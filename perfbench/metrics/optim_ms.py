"""``optim_ms``: device milliseconds per step of the work launched inside
``torch.optim``'s ``Optimizer.step`` ranges (the trainers' Adam update)."""


def read(trace, driver):
    seconds, ranges = trace.ranges("Optimizer.step")
    if not ranges or not driver.log:
        return None
    return seconds * 1e3 / len(driver.log)
