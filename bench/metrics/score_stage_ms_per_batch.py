"""Host milliseconds a batch ``ServeEngine.run`` spent staging the codes in
the traced window (to the device, the cast, ``contiguous``): the span
``repro.serve.stage`` (``kernels/lut_serve.py``)."""

from bench.metrics._spans import span_ms


def read(run):
    return span_ms(run, "batches", "repro.serve.stage")
