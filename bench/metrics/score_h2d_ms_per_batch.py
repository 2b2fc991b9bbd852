"""Milliseconds of host-to-device copies a batch in the traced window (the
profiler's ``Memcpy HtoD`` events over the traced batches)."""

from bench.profiling import kernel_time


def read(run):
    tr = run.get("trace")
    if not tr or not tr.get("batches"):
        return None
    t, n = kernel_time(tr["ops"], ("HtoD",))
    return t / tr["batches"] * 1e3 if n else None
