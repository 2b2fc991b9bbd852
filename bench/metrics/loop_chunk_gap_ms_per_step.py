"""Device milliseconds a step between one chunk's end and the next chunk's
start on the device clock in the traced window: the marks ``loop`` ``end``
to the next ``start`` (``train/loop.py``); the metrics transfer and the
host's time between chunks."""

from bench.metrics._spans import interval_ms


def read(run):
    return interval_ms(run, "steps", "loop", "gap_ms")
