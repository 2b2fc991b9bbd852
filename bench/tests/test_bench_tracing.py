"""The readers of the program's spans and marks (``bench/metrics/_spans.py``
and the readers on it) against synthetic records, the program's own record
on the CPU, and an empty record."""

import pytest
from torch.profiler import ProfilerActivity, profile

from bench import harness
from repro_torch import tracing

SPANS = {"loop_prefetch_wait_ms_per_step": ("steps", "repro.loop.prefetch_wait"),
         "prefetch_build_ms_per_step": ("steps", "repro.prefetch.build"),
         "loop_sync_ms_per_step": ("steps", "repro.loop.sync"),
         "score_stage_ms_per_batch": ("batches", "repro.serve.stage")}
MARKS = {"loop_graph_ms_per_step": ("steps", "loop", "busy_ms"),
         "loop_chunk_gap_ms_per_step": ("steps", "loop", "gap_ms"),
         "score_batch_gap_ms_per_batch": ("batches", "serve", "gap_ms")}
NEW = sorted(SPANS) + sorted(MARKS) + ["score_gate_oracle_s"]


def _read(name, run):
    return harness.reader(name).read(run)


def _synthetic(names_ns, intervals):
    spans = [tracing.Span(n, None, "main", t0, t0 + d) for n, t0, d in names_ns]
    return {"spans": spans, "intervals": intervals}


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_readers_sum_their_span_per_unit(monkeypatch, name):
    unit, span = SPANS[name]
    rec = _synthetic([(span, 0, 3_000_000), ("repro.other", 0, 9_000_000),
                      (span, 10_000_000, 1_000_000)], {})
    monkeypatch.setattr(tracing, "record", lambda: rec)
    # 4 ms over 8 steps or batches
    assert _read(name, {"trace": {unit: 8}}) == pytest.approx(0.5)


@pytest.mark.parametrize("name", sorted(MARKS))
def test_mark_readers_sum_their_intervals_per_unit(monkeypatch, name):
    unit, group, kind = MARKS[name]
    other = "gap_ms" if kind == "busy_ms" else "busy_ms"
    rec = _synthetic([], {group: {kind: [1.5, 2.5, 2.0], other: [100.0]},
                          "elsewhere": {kind: [50.0]}})
    monkeypatch.setattr(tracing, "record", lambda: rec)
    assert _read(name, {"trace": {unit: 4}}) == pytest.approx(1.5)


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_on_an_empty_record(name):
    for run in ({"trace": {"steps": 8, "batches": 8}}, {"trace": None}, {},
                {"build_s": {"lower_s": 1.0}}):
        assert _read(name, run) is None


def test_gate_oracle_reader():
    assert _read("score_gate_oracle_s", {"build_s": {"gate_oracle_s": 2.5,
                                                     "gate_s": 3.0}}) == 2.5


def test_span_reader_on_the_program_record():
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with tracing.span("repro.loop.sync"):
                pass
    got = _read("loop_sync_ms_per_step", {"trace": {"steps": 6}})
    spans = [s for s in tracing.record()["spans"] if s.name == "repro.loop.sync"]
    assert len(spans) == 3
    assert got == pytest.approx(sum(s.end_ns - s.start_ns for s in spans) * 1e-6 / 6)
    # a dotted alias is read by its base's reader
    assert harness.reader_path("loop_sync_ms_per_step.sweep").stem == "loop_sync_ms_per_step"
