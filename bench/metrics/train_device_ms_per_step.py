"""Device busy milliseconds a step in the traced chunks: the union of the
profiler's kernels, copies and fills over the traced steps."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr.get("steps") or tr["busy_s"] <= 0:
        return None
    return tr["busy_s"] / tr["steps"] * 1e3
