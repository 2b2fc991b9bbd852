"""Samples trained in the window over the window's seconds (host clock)."""


def read(run):
    if "samples" not in run or run["window_s"] <= 0:
        return None
    return run["samples"] / run["window_s"]
