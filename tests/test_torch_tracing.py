"""The port's tracing (``repro_torch/tracing.py``) on the CPU.

Tracing is on exactly while a ``torch.profiler`` window is open: outside
one a span is the shared no-op and a mark does nothing; inside one the
spans land in the record with their parents and in the profiler's chrome
trace as user annotations.  The chunked loop, its prefetcher and the score
call open their spans and change no bit of what they compute; the build's
gate times its oracle apart, outside the attestation; the launch counters'
old names count in the one store.  The ``cuda``-marked test holds the
device-clock marks of a graph-mode loop on the card.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import interop, tracing
from repro_torch.core.ebops import BetaSchedule
from repro_torch.core.lower import compile_sequential
from repro_torch.core.lut_layers import LUTDense
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ops
from repro_torch.kernels.lut_serve import compile_program
from repro_torch.launch.serve import build_lut_stack
from repro_torch.optim.adam import AdamConfig
from repro_torch.serve.api import EngineSpec, build
from repro_torch.train.loop import chunked_train, run_chunked
from repro_torch.train.steps import TrainHParams, make_lut_train_step, named_params

torch.set_num_threads(2)


def _port_setup(dims=(6, 5, 3), batch=16, device="cpu"):
    """A LUT-Dense stack (batch-norm in layer 0), its fused step, its Adam
    init and a batch function of the step alone."""
    hp = TrainHParams(adam=AdamConfig(lr=1e-3), beta=BetaSchedule(5e-7, 1e-4, 40),
                      lut_use_fused=True)
    layers = [LUTDense(ci, co, hidden=3 if device == "cpu" else 8,
                       use_batchnorm=(k == 0), device=device,
                       generator=torch.Generator().manual_seed(k))
              for k, (ci, co) in enumerate(zip(dims[:-1], dims[1:]))]
    step_fn, init_fn = make_lut_train_step(layers, hp)

    def get_batch(step):
        rng = np.random.default_rng([23, step])
        return {"x": rng.normal(0, 1, (batch, dims[0])).astype(np.float32),
                "y": rng.integers(0, dims[-1], batch).astype(np.int32)}

    return layers, step_fn, init_fn, get_batch


def _state_bytes(layers, opt) -> dict:
    """Parameters, BN stats and Adam state as bytes, by path."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = np.asarray(tree).tobytes()

    walk({"params": interop.stack_params_to_numpy(layers),
          "opt": interop.opt_state_to_numpy(layers, opt)}, "")
    return out


@pytest.fixture(autouse=True)
def clean_record():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _names(rec):
    return [s.name for s in rec["spans"]]


@pytest.fixture(scope="module")
def small_prog():
    layers = build_lut_stack([6, 4, 3], 3, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return compile_sequential(layers, 4, 2)


# ------------------------------------------------------------------ off
def test_off_outside_a_profiler():
    a, b = tracing.span("repro.test.a"), tracing.span("repro.test.b")
    assert a is b                               # the one shared no-op
    with a:
        with b:
            pass
    # a CUDA device would need the card: off, the mark never reaches it
    tracing.mark("loop", "start", "cuda")
    tracing.mark("loop", "bogus", "cuda")
    assert tracing.record() == {"spans": [], "intervals": {}}


def test_timed_span_reads_its_clock_off_and_records_nothing():
    with tracing.span("repro.test.timed", timed=True) as sp:
        pass
    assert sp.end_ns >= sp.start_ns and sp.seconds == (sp.end_ns - sp.start_ns) * 1e-9
    assert tracing.record()["spans"] == []


# ------------------------------------------------------------------- on
def test_spans_under_a_profiler_land_in_the_record_and_the_trace(tmp_path):
    with _cpu_profile() as prof:
        with tracing.span("repro.test.outer"):
            with tracing.span("repro.test.inner"):
                torch.ones(4).sum()
            tracing.mark("loop", "start", "cpu")     # no mark on the CPU
        worker = threading.Thread(target=lambda: tracing.span("repro.test.worker").__enter__()
                                  .__exit__(None, None, None), name="tracing-test")
        worker.start()
        worker.join()
    with tracing.span("repro.test.after"):          # the window has closed
        pass
    rec = tracing.record()
    got = {s.name: s for s in rec["spans"]}
    assert _names(rec) == ["repro.test.inner", "repro.test.outer", "repro.test.worker"]
    assert got["repro.test.inner"].parent == "repro.test.outer"
    assert got["repro.test.outer"].parent is None
    assert got["repro.test.worker"].parent is None
    assert got["repro.test.worker"].thread == "tracing-test"
    outer, inner = got["repro.test.outer"], got["repro.test.inner"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert rec["intervals"] == {}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"repro.test.outer", "repro.test.inner"} <= annotated


def test_a_span_that_outlives_the_window_is_not_recorded():
    prof = _cpu_profile()
    prof.__enter__()
    with tracing.span("repro.test.inside"):
        pass
    straddling = tracing.span("repro.test.straddling")
    straddling.__enter__()
    prof.__exit__(None, None, None)
    straddling.__exit__(None, None, None)
    assert _names(tracing.record()) == ["repro.test.inside"]


def test_reset_clears_the_record():
    with _cpu_profile():
        with tracing.span("repro.test.a"):
            pass
    assert _names(tracing.record()) == ["repro.test.a"]
    tracing.reset()
    assert tracing.record()["spans"] == []


class _FakeEvent:
    """A recorded event at device time ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, later):
        return later.t - self.t


def test_record_pairs_marks_per_group_and_thread(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    dev = torch.device("cuda", 0)
    marks = [("loop", "start", "main", 0.0), ("serve", "start", "other", 0.5),
             ("loop", "end", "main", 2.0), ("serve", "end", "other", 1.5),
             ("loop", "start", "main", 2.25), ("loop", "end", "main", 5.0),
             ("serve", "start", "main", 6.0), ("serve", "end", "main", 7.0),
             ("loop", "start", "main", 5.5)]
    monkeypatch.setattr(tracing, "_MARKS",
                        [(g, e, th, _FakeEvent(t), dev) for g, e, th, t in marks])
    got = tracing.record()["intervals"]
    assert got["loop"] == {"busy_ms": [2.0, 2.75], "gap_ms": [0.25, 0.5]}
    # the two threads' serve marks are never paired with each other
    assert got["serve"] == {"busy_ms": [1.0, 1.0], "gap_ms": []}


# ------------------------------------------------------------ the loop
def _run_loop(traced, prefetch=True, steps=9):
    layers, step_fn, init_fn, get_batch = _port_setup()
    results = []

    def go():
        for r in chunked_train(step_fn, named_params(layers), init_fn(), get_batch, 0,
                               steps, chunk_steps=4, prefetch=prefetch):
            results.append(r)

    if traced:
        with _cpu_profile():
            go()
    else:
        go()
    return layers, results


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "sync"])
def test_eager_loop_spans_and_bits(prefetch):
    ref_layers, ref = _run_loop(False, prefetch)
    assert tracing.record()["spans"] == []
    layers, got = _run_loop(True, prefetch)
    rec = tracing.record()
    names = _names(rec)
    n = len(got)
    assert n == 3
    assert names.count("repro.loop.enqueue") == n
    assert names.count("repro.loop.sync") == n
    assert names.count("repro.prefetch.build") == n
    # one wait a chunk, and the last for the worker's end
    assert names.count("repro.loop.prefetch_wait") == (n + 1 if prefetch else 0)
    if prefetch:
        builds = [s for s in rec["spans"] if s.name == "repro.prefetch.build"]
        assert {s.thread for s in builds} == {"host-prefetch"}
    enqueue = [s for s in rec["spans"] if s.name == "repro.loop.enqueue"]
    # host_s is the enqueue span's interval: the same two clock reads
    assert [r.host_s for r in got] == [(s.end_ns - s.start_ns) * 1e-9 for s in enqueue]
    assert rec["intervals"] == {}                   # no mark on the CPU
    assert _state_bytes(layers, got[-1].opt_state) == _state_bytes(ref_layers,
                                                                   ref[-1].opt_state)
    for a, b in zip(got, ref):
        assert (a.step, a.k) == (b.step, b.k)
        assert {k: v.tobytes() for k, v in a.metrics.items()} == \
            {k: v.tobytes() for k, v in b.metrics.items()}


def test_run_chunked_untraced_records_nothing():
    layers, step_fn, init_fn, get_batch = _port_setup()
    run_chunked(step_fn, named_params(layers), init_fn(), get_batch, 0, 5, chunk_steps=2)
    assert tracing.record() == {"spans": [], "intervals": {}}


# ----------------------------------------------------------- the score call
def test_serve_run_spans(small_prog):
    eng = compile_program(small_prog, device="cpu", engine="pallas")
    codes = np.zeros((5, eng.n_inputs), np.int64)
    want = eng.run(codes)
    assert tracing.record()["spans"] == []
    with _cpu_profile():
        got = eng.run(codes)
    assert torch.equal(got, want)
    rec = tracing.record()
    assert _names(rec) == ["repro.serve.stage", "repro.serve.launch", "repro.serve.run"]
    parents = {s.name: s.parent for s in rec["spans"]}
    assert parents == {"repro.serve.stage": "repro.serve.run",
                       "repro.serve.launch": "repro.serve.run", "repro.serve.run": None}


@pytest.mark.parametrize("verify", ["full", "skip"])
def test_build_times_the_gate_oracle_outside_the_attestation(small_prog, verify):
    built = build(small_prog, EngineSpec(engine="pallas", verify=verify), device="cpu")
    if verify == "skip":
        assert "gate_oracle_s" not in built.timings and built.attestation is None
        return
    t = built.timings
    assert isinstance(t["gate_oracle_s"], float)
    assert 0.0 < t["gate_oracle_s"] <= t["gate_s"]
    assert set(built.attestation) == {"random", "exhaustive", "max_width", "n_groups"}


# ----------------------------------------------------------- the counters
def test_launch_counters_old_names_count_in_one_store():
    assert kbuild.LAUNCHES is tracing.LAUNCHES
    assert set(kbuild.SOURCES) <= set(ops.launch_counts())
    assert ops.launch_counts is tracing.launch_counts
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    kbuild.count_launch("lut_dense")
    tracing.count_launch("lut_serve", 3)
    got = ops.launch_counts()
    assert got["lut_dense"] == 1 and got["lut_serve"] == 3 and got["fake_quant"] == 0
    assert kbuild.LAUNCHES["lut_serve"] == 3
    kbuild.reset_launches()
    assert set(ops.launch_counts().values()) == {0}


# ----------------------------------------------------------------- the card
@pytest.mark.cuda
def test_graph_loop_marks_on_the_card():
    """Graph mode under a profiler: one ``loop`` interval a chunk, one gap
    fewer, on the device clock; a mark inside a capture records nothing."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an NVIDIA H100 (sm_90) card; none is visible")
    dev = torch.device("cuda", 0)
    layers, step_fn, init_fn, get_batch = _port_setup((16, 20, 5), 1024, dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        res = list(chunked_train(step_fn, named_params(layers), init_fn(), get_batch, 0, 24,
                                 chunk_steps=4, mode="graph"))
        graph = torch.cuda.CUDAGraph()
        x = torch.zeros(8, device=dev)
        s = torch.cuda.Stream(dev)
        with torch.cuda.stream(s):
            with torch.cuda.graph(graph, stream=s):
                tracing.mark("captured", "start", dev)
                x.add_(1)
                tracing.mark("captured", "end", dev)
        graph.replay()
    rec = tracing.record()
    loop = rec["intervals"]["loop"]
    assert len(res) == 6 and res[0].compiled
    assert len(loop["busy_ms"]) == 6 and len(loop["gap_ms"]) == 5
    assert all(v > 0 for v in loop["busy_ms"]) and all(v >= 0 for v in loop["gap_ms"])
    assert "captured" not in rec["intervals"]
    assert float(x[0]) == 1.0
