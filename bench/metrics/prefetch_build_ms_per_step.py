"""Host milliseconds a step the prefetcher's worker spent building chunks in
the traced window (each step's rows, the pinned stack, the copy's start):
the span ``repro.prefetch.build`` (``data/pipeline.py``)."""

from bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "steps", "repro.prefetch.build")
