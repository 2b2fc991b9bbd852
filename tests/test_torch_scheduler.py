"""The port's micro-batching scheduler, on the CPU.

* Parity: the same codes go through the reference's ``MicroBatcher`` over
  its engine and the port's ``MicroBatcher`` over the port's engine (the
  packed chain's plain version and the fused runner); the outputs equal
  each other and ``DaisProgram.run``.  ``compare_under_load`` of both
  packages reports rows with the same keys and request counts for a burst,
  and refuses an engine that answers wrongly.
* The reference's behaviour cases (``tests/test_serve_scheduler.py``):
  buckets, the deadline flush, a request during a flush, a split backlog,
  out-of-order scatter, lifecycle, restart, stop racing submits, admission,
  the open-loop driver, stats, engine failures.  Fake engines block on
  events, so order comes from events, never from a sleep; every wait has a
  timeout.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro.kernels import lut_serve as ref_serve
from repro.serve import scheduler as ref_sched
from repro_torch.core.lower import compile_sequential
from repro_torch.kernels.lut_serve import compile_program, input_code_bounds
from repro_torch.launch.serve import build_lut_stack
from repro_torch.serve.scheduler import (BatcherConfig, InterpreterBackend,
                                         MicroBatcher, RejectedError,
                                         ServeConfig, bucket_for,
                                         bucket_ladder, compare_under_load,
                                         drive_open_loop)

torch.set_num_threads(2)

WAIT = 30           # seconds: the bound on every wait


class EchoEngine:
    """Deterministic per-row transform — scatter errors become visible."""

    def __init__(self, n_inputs=4):
        self.n_inputs = n_inputs

    def run(self, x):
        x = np.asarray(x, np.int64)
        return x * 7 + np.arange(x.shape[1])[None, :]


class GateEngine(EchoEngine):
    """Blocks the first ``n_gated`` run() calls until ``release`` is set;
    ``entered`` is set when the first call starts."""

    def __init__(self, n_inputs=4, n_gated=None):
        super().__init__(n_inputs)
        self.release = threading.Event()
        self.entered = threading.Event()
        self.n_gated = n_gated
        self.calls = []
        self.done_order = []
        self._lock = threading.Lock()

    def run(self, x):
        with self._lock:
            k = len(self.calls)
            self.calls.append(np.asarray(x).shape[0])
        self.entered.set()
        if self.n_gated is None or k < self.n_gated:
            assert self.release.wait(timeout=WAIT)
        out = super().run(x)
        with self._lock:
            self.done_order.append(np.asarray(x).shape[0])
        return out


class TensorEcho(EchoEngine):
    """Echo that answers with a torch tensor, as the port's engines do."""

    def run(self, x):
        return torch.as_tensor(super().run(x))


def _expected(codes):
    return EchoEngine().run(np.atleast_2d(codes))


def _results(futs):
    return np.stack([f.result(timeout=WAIT) for f in futs])


# --------------------------------------------------------------------------- #
# parity with the reference over real engines
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jsc():
    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    prog = compile_sequential(layers, 4, 2)
    ref = RefDaisProgram.from_arrays(prog.to_arrays())
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(5).integers(lo, hi + 1, (200, len(lo)))
    return prog, ref, codes


@pytest.mark.parametrize("engine", ["pallas", "fused"])
@pytest.mark.parametrize("n_workers", [1, 2])
def test_scheduler_parity_with_the_reference(jsc, engine, n_workers):
    prog, ref, codes = jsc
    cfg = dict(max_batch=16, max_delay_ms=2.0, n_workers=n_workers)
    port_engine = compile_program(prog, device="cpu", engine=engine)
    with MicroBatcher(port_engine, ServeConfig(**cfg)) as mb:
        got = _results(mb.submit_many(codes))
    with ref_sched.MicroBatcher(ref_serve.compile_program(ref),
                                ref_sched.ServeConfig(**cfg)) as rmb:
        want = np.stack([f.result(timeout=WAIT) for f in rmb.submit_many(codes)])
    assert got.dtype == np.int32 and got.shape == (len(codes), 5)
    np.testing.assert_array_equal(got.astype(np.int64), np.asarray(want, np.int64))
    np.testing.assert_array_equal(got.astype(np.int64), ref.run(codes))
    s = mb.stats()
    assert s.n_requests == len(codes) and s.engine_path == engine
    assert s.mean_bucket <= 16 and 0.0 <= s.pad_overhead < 1.0


def test_compare_under_load_parity(jsc):
    prog, ref, codes = jsc
    cfg = dict(max_batch=64, max_delay_ms=2.0)
    rows = compare_under_load(prog, compile_program(prog, device="cpu", engine="pallas"),
                              codes, ServeConfig(**cfg), rates=[0.0])
    ref_rows = ref_sched.compare_under_load(ref, ref_serve.compile_program(ref), codes,
                                            ref_sched.ServeConfig(**cfg), rates=[0.0])
    assert [r["backend"] for r in rows] == [r["backend"] for r in ref_rows] \
        == ["engine", "interp"]
    for r, rr in zip(rows, ref_rows):
        assert r.keys() == rr.keys()
        assert r["n_requests"] == rr["n_requests"] == len(codes)
        assert r["rows_per_s"] > 0 and r["offered_rate"] == 0.0


def test_compare_under_load_refuses_a_wrong_engine(jsc):
    prog, _ref, codes = jsc
    engine = compile_program(prog, device="cpu", engine="pallas")

    class OffByOne:
        n_inputs = engine.n_inputs

        def run(self, x):
            return engine.run(x) + 1

    with pytest.raises(AssertionError, match="diverged"):
        compare_under_load(prog, OffByOne(), codes[:32], ServeConfig(max_batch=16),
                           rates=[0.0])


def test_warm_runs_the_ladder_and_clone_shares_the_runner(jsc):
    prog, _ref, codes = jsc
    engine = compile_program(prog, device="cpu", engine="pallas")
    assert engine.warm(bucket_ladder(64)) == [1, 2, 4, 8, 16, 32, 64]
    twin = engine.clone()
    assert twin is not engine and twin._runner is engine._runner
    assert torch.equal(twin.run(codes), engine.run(codes))
    assert InterpreterBackend(prog).n_inputs == engine.n_inputs


# --------------------------------------------------------------------------- #
# bucket math, config
# --------------------------------------------------------------------------- #
def test_bucket_ladder_rounding_and_config():
    assert bucket_ladder(8) == [1, 2, 4, 8]
    assert [bucket_for(n, 8) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match="power of two"):
        bucket_ladder(12)
    with pytest.raises(ValueError, match="power of two"):
        MicroBatcher(EchoEngine(), ServeConfig(max_batch=10))
    with pytest.raises(ValueError, match="tier policy"):
        MicroBatcher(EchoEngine(),
                     ServeConfig(max_queue=4, overload_policy="shed-oldest"))
    with pytest.raises(ValueError, match="overload_policy"):
        ServeConfig(overload_policy="drop-newest")
    with pytest.raises(ValueError, match="max_queue"):
        ServeConfig(max_queue=0)
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        cfg = BatcherConfig(max_batch=8)
    assert isinstance(cfg, ServeConfig) and cfg.max_batch == 8


# --------------------------------------------------------------------------- #
# coalescing
# --------------------------------------------------------------------------- #
def test_partial_bucket_flushes_at_deadline():
    cfg = ServeConfig(max_batch=64, max_delay_ms=150.0, warmup=False)
    with MicroBatcher(EchoEngine(), cfg) as mb:
        codes = np.arange(12, dtype=np.int64).reshape(3, 4)
        t0 = time.monotonic()
        res = _results(mb.submit_many(codes))
        waited = time.monotonic() - t0
    np.testing.assert_array_equal(res, _expected(codes))
    s = mb.stats()
    assert s.n_batches == 1 and s.mean_batch_fill == 3.0 and s.mean_bucket == 4.0
    assert waited >= 0.10


def test_request_during_flush_joins_next_batch():
    eng = GateEngine(n_gated=1)
    cfg = ServeConfig(max_batch=8, max_delay_ms=5.0, warmup=False)
    with MicroBatcher(eng, cfg) as mb:
        first = mb.submit(np.asarray([1, 2, 3, 4], np.int64))
        assert eng.entered.wait(timeout=WAIT)       # flush 1 blocked in run()
        second = mb.submit(np.asarray([5, 6, 7, 8], np.int64))
        assert not first.done()
        eng.release.set()
        r1, r2 = first.result(timeout=WAIT), second.result(timeout=WAIT)
    np.testing.assert_array_equal(r1, _expected([1, 2, 3, 4])[0])
    np.testing.assert_array_equal(r2, _expected([5, 6, 7, 8])[0])
    assert mb.stats().n_batches == 2 and eng.calls == [1, 1]


def test_oversized_backlog_splits_into_max_batch_chunks():
    eng = GateEngine()
    # a deadline far longer than submitting 20 rows takes: the backlog is
    # one flush, split into max_batch chunks
    cfg = ServeConfig(max_batch=8, max_delay_ms=500.0, warmup=False)
    codes = np.random.default_rng(0).integers(-50, 50, (21, 4))
    with MicroBatcher(eng, cfg) as mb:
        probe = mb.submit(codes[0])
        assert eng.entered.wait(timeout=WAIT)       # the single worker is busy
        futs = mb.submit_many(codes[1:])
        eng.release.set()
        res = np.stack([probe.result(timeout=WAIT)] + list(_results(futs)))
    np.testing.assert_array_equal(res, _expected(codes))
    assert eng.calls[0] == 1 and sorted(eng.calls[1:]) == [4, 8, 8]
    assert mb.stats().n_requests == 21


def test_scatter_correct_when_batches_complete_out_of_order():
    eng = GateEngine(n_gated=1)                     # only the first call blocks
    cfg = ServeConfig(max_batch=4, max_delay_ms=1.0, n_workers=2, warmup=False)
    with MicroBatcher(eng, cfg) as mb:
        a = mb.submit_many(np.arange(16, dtype=np.int64).reshape(4, 4))
        assert eng.entered.wait(timeout=WAIT)       # batch A held in worker 1
        b = mb.submit_many(np.arange(100, 108, dtype=np.int64).reshape(2, 4))
        res_b = _results(b)
        assert not a[0].done()                      # B finished while A ran
        eng.release.set()
        res_a = _results(a)
    assert eng.done_order == [2, 4]
    np.testing.assert_array_equal(res_a, _expected(np.arange(16).reshape(4, 4)))
    np.testing.assert_array_equal(res_b, _expected(np.arange(100, 108).reshape(2, 4)))


# --------------------------------------------------------------------------- #
# lifecycle
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", [EchoEngine, TensorEcho])
def test_submit_validates_shape_and_lifecycle(engine):
    mb = MicroBatcher(engine(), ServeConfig(warmup=False))
    with pytest.raises(RuntimeError, match="not running"):
        mb.submit(np.zeros(4, np.int64))
    mb.start()
    with pytest.raises(RuntimeError, match="already started"):
        mb.start()
    with pytest.raises(ValueError, match="codes"):
        mb.submit(np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="codes"):
        mb.submit(np.zeros((2, 4), np.int64))
    f1 = mb.submit(np.ones(4, np.int64))
    mb.stop()                                       # drains before joining
    np.testing.assert_array_equal(f1.result(timeout=WAIT), _expected(np.ones((1, 4)))[0])
    with pytest.raises(RuntimeError, match="not running"):
        mb.submit(np.zeros(4, np.int64))
    mb.start()                                      # stopped != dead
    f2 = mb.submit(np.full(4, 2, np.int64))
    mb.stop()
    np.testing.assert_array_equal(f2.result(timeout=WAIT),
                                  _expected(np.full((1, 4), 2))[0])
    assert mb.stats().n_requests == 2


def test_stop_never_strands_concurrent_submits():
    mb = MicroBatcher(EchoEngine(), ServeConfig(max_delay_ms=1.0, warmup=False))
    mb.start()
    futures, started, done = [], threading.Event(), threading.Event()

    def hammer():
        while not done.is_set():
            try:
                futures.append(mb.submit(np.ones(4, np.int64)))
            except RuntimeError:
                break
            started.set()

    t = threading.Thread(target=hammer)
    t.start()
    assert started.wait(timeout=WAIT)
    mb.stop()
    done.set()
    t.join(timeout=WAIT)
    assert not t.is_alive() and futures
    expected = _expected(np.ones((1, 4)))[0]
    for f in futures:
        try:
            np.testing.assert_array_equal(f.result(timeout=WAIT), expected)
        except RuntimeError:
            pass                      # "stopped before request ran" is fine


# --------------------------------------------------------------------------- #
# admission, the driver, stats, failures
# --------------------------------------------------------------------------- #
def test_bounded_queue_rejects_at_admission():
    eng = GateEngine()
    cfg = ServeConfig(max_batch=4, max_delay_ms=1.0, max_queue=3, warmup=False)
    with MicroBatcher(eng, cfg) as mb:
        admitted, rejected = [], 0
        for k in range(10):
            try:
                admitted.append((k, mb.submit(np.full(4, k, np.int64))))
            except RejectedError:
                rejected += 1
        assert len(admitted) == 3 and rejected == 7   # nothing is served yet
        eng.release.set()
        for k, f in admitted:
            np.testing.assert_array_equal(f.result(timeout=WAIT),
                                          _expected(np.full((1, 4), k))[0])
    s = mb.stats()
    assert s.n_rejected == rejected and s.n_requests == len(admitted)


@pytest.mark.parametrize("rate", [2000.0, 0.0])
def test_drive_open_loop(rate):
    cfg = ServeConfig(max_batch=8, max_delay_ms=1.0, warmup=False)
    codes = np.arange(80, dtype=np.int64).reshape(20, 4)
    with MicroBatcher(EchoEngine(), cfg) as mb:
        out, info = drive_open_loop(mb, codes, rate=rate)
    np.testing.assert_array_equal(out, _expected(codes))
    assert info["requested_rate"] == rate and info["n_requests"] == 20
    assert info["wall_s"] > 0 and info["max_late_ms"] >= 0.0
    if rate > 0:
        assert 0 < info["achieved_rate"] <= 2 * rate


@pytest.mark.parametrize("rate", [0.0, 2000.0])
def test_drive_open_loop_submits_through_a_tier(jsc, rate):
    """``submit=`` routes every row through a 2-replica tier (``batcher`` is
    None), as the Pareto launcher drives it: results in submission order,
    each bit-exact against ``DaisProgram.run``."""
    from repro_torch.serve.api import EngineSpec, serve
    from repro_torch.serve.tier import TierConfig

    prog, _ref, codes = jsc
    tier = serve({"jsc": prog}, EngineSpec(engine="pallas", require="pallas", n_random=64),
                 TierConfig(n_replicas=2, serve=ServeConfig(max_batch=16, max_delay_ms=1.0)),
                 device="cpu")
    seen = []

    def submit(row):
        seen.append(row)
        return tier.submit(row, "jsc")

    try:
        out, info = drive_open_loop(None, codes[:96], rate, submit=submit)
    finally:
        tier.stop()
    assert len(seen) == 96 and all(np.array_equal(a, b) for a, b in zip(seen, codes))
    np.testing.assert_array_equal(np.asarray(out, np.int64), prog.run(codes[:96]))
    assert info["n_requests"] == 96 and info["requested_rate"] == rate
    assert tier.stats().n_batches >= 96 // 16


def test_stats_dataclass():
    cfg = ServeConfig(max_batch=8, max_delay_ms=1.0, warmup=False)
    mb = MicroBatcher(EchoEngine(), cfg)
    assert mb.stats().n_requests == 0 and mb.stats().p50_ms == 0.0
    with mb:
        _results(mb.submit_many(np.arange(8, dtype=np.int64).reshape(2, 4)))
    s = mb.stats()
    assert s.n_requests == 2 and s.as_dict()["n_requests"] == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.n_requests = 3


def test_engine_failure_propagates_to_every_future_of_the_batch():
    class BoomEngine(GateEngine):
        def run(self, x):
            super().run(x)
            raise RuntimeError("boom")

    eng = BoomEngine()
    with MicroBatcher(eng, ServeConfig(max_batch=4, warmup=False)) as mb:
        futs = mb.submit_many(np.zeros((4, 4), np.int64))
        eng.release.set()
        for f in futs:
            with pytest.raises(RuntimeError, match="boom"):
                f.result(timeout=WAIT)
        # the scheduler survives a failed batch
        ok = mb.submit(np.ones(4, np.int64))
        with pytest.raises(RuntimeError, match="boom"):
            ok.result(timeout=WAIT)
    assert eng.calls == [4, 1]
