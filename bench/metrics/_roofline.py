"""Shared by the ``b*_roofline`` readers: a kernel's bound of one launch at
the cell's shapes (the run's ``kernel_bounds``) over the mean device time of
its recorded events in the traced window, in percent."""

from bench.profiling import kernel_time


def share(run, kernel, marks):
    tr = run.get("trace")
    bound = run.get("kernel_bounds", {}).get(kernel)
    if not tr or bound is None:
        return None
    t, n = kernel_time(tr["ops"], marks)
    if n == 0 or t <= 0:
        return None
    return bound / (t / n) * 100
