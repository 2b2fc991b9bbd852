"""Device milliseconds a batch between one score call's end and the next
call's start on the device clock in the traced window: the marks ``serve``
``end`` (after the runner) to the next ``start`` (before the staging),
``kernels/lut_serve.py``; the outputs' copy and the caller's time."""

from bench.metrics._spans import interval_ms


def read(run):
    return interval_ms(run, "batches", "serve", "gap_ms")
