"""Rows scored in the window, with their outputs on the host, over the
window's seconds (host clock)."""


def read(run):
    if "rows" not in run or run["window_s"] <= 0:
        return None
    return run["rows"] / run["window_s"]
