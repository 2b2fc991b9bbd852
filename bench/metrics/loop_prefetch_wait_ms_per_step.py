"""Host milliseconds a step the chunked loop waited for the prefetcher's next
chunk in the traced window: the span ``repro.loop.prefetch_wait``
(``data/pipeline.py``, the consumer's blocking get)."""

from bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "steps", "repro.loop.prefetch_wait")
