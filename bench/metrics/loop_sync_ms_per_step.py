"""Host milliseconds a step the chunked loop spent in its one metrics
transfer a chunk, which waits for the chunk to end, in the traced window:
the span ``repro.loop.sync`` (``train/loop.py``)."""

from bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "steps", "repro.loop.sync")
