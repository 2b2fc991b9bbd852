"""Device milliseconds a step from each chunk's start to its end on the
device clock in the traced window: the marks ``loop`` ``start`` (before the
chunk's call, so its batch copy too) to ``end`` (after the call returns),
``train/loop.py``.  Less ``train_device_ms_per_step``, the idle time inside
the chunks."""

from bench.metrics._spans import interval_ms


def read(run):
    return interval_ms(run, "steps", "loop", "busy_ms")
