"""Shared by the readers of the program's own spans and device-clock marks
(``repro_torch/tracing.py``), which the program records while the traced
window's profiler is open: their time summed over the window, in
milliseconds a step (train cells, ``run["trace"]["steps"]``) or a batch
(the score cell, ``run["trace"]["batches"]``).  A program without the
tracing module, or a record without the span or mark, gives None."""


def _record(run, unit):
    tr = run.get("trace")
    if not tr or not tr.get(unit):
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.record()


def span_ms(run, unit, name):
    """Milliseconds a ``unit`` in the spans named ``name``."""
    rec = _record(run, unit)
    if rec is None:
        return None
    ns = [s.end_ns - s.start_ns for s in rec["spans"] if s.name == name]
    return sum(ns) * 1e-6 / run["trace"][unit] if ns else None


def interval_ms(run, unit, group, kind):
    """Milliseconds a ``unit`` in the device-clock intervals of mark group
    ``group``: ``"busy_ms"`` (start to end) or ``"gap_ms"`` (end to the
    next start)."""
    rec = _record(run, unit)
    if rec is None:
        return None
    ms = rec["intervals"].get(group, {}).get(kind)
    return sum(ms) / run["trace"][unit] if ms else None
