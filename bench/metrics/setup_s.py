"""Seconds from the start of the run to the start of the window: imports,
CUDA start-up, kernel builds (first run), inputs, the program's set-up and
warm-up (host clock)."""


def read(run):
    return run.get("setup_s")
