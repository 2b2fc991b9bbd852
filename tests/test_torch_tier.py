"""The port's serving tier and model registry, on the CPU.

* Parity: two real models behind the reference's ``ServeTier`` (its
  engines) and the port's (the port's engines on the CPU), fed the same
  interleaved requests; every response equals the other package's and its
  own model's ``DaisProgram.run``.  ``serve()`` over bundle paths of both
  showcase models, with a mid-load hot-swap of one model for its DCE'd
  engine: no request fails and none is served by a torn-down engine.
* The reference's behaviour cases (``tests/test_serve_tier.py``): registry
  publish / swap / lease drain, submit validation, admission (reject and
  shed-oldest), work stealing, deadline buckets, deadline misses, hot-swap
  under load.  Fake engines block on events, so order comes from events;
  every wait has a timeout.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro.serve import api as ref_api
from repro.serve import tier as ref_tier
from repro.serve.scheduler import ServeConfig as RefServeConfig
from repro_torch.core.dais import DaisProgram
from repro_torch.core.lower import compile_sequential
from repro_torch.kernels.lut_serve import input_code_bounds
from repro_torch.launch.serve import build_lut_stack
from repro_torch.serve.api import EngineSpec, build, serve, tier_from_built
from repro_torch.serve.artifact import save_artifact
from repro_torch.serve.registry import ModelInfo, ModelRegistry, RegistryError
from repro_torch.serve.scheduler import RejectedError, ServeConfig
from repro_torch.serve.tier import ServeTier, TierConfig, TierStats

torch.set_num_threads(2)

WAIT = 30           # seconds: the bound on every wait


class EchoEngine:
    """Deterministic per-row transform; records what it served."""

    def __init__(self, tag=0, n_inputs=4):
        self.tag = tag
        self.n_inputs = n_inputs
        self.closed = False
        self.runs_after_close = 0
        self.calls = []

    def run(self, x):
        if self.closed:
            self.runs_after_close += 1
        x = np.asarray(x, np.int64)
        self.calls.append(x.shape[0])
        return x * 10 + self.tag

    def close(self):
        self.closed = True


class GateEngine(EchoEngine):
    """Blocks the first ``n_gated`` run() calls until ``release`` is set;
    ``entered`` is set when the first call starts."""

    def __init__(self, tag=0, n_inputs=4, n_gated=None):
        super().__init__(tag, n_inputs)
        self.release = threading.Event()
        self.entered = threading.Event()
        self.n_gated = n_gated
        self._n = 0
        self._lock = threading.Lock()

    def run(self, x):
        with self._lock:
            k, self._n = self._n, self._n + 1
        self.entered.set()
        if self.n_gated is None or k < self.n_gated:
            assert self.release.wait(timeout=WAIT)
        return super().run(x)


def _tier(engine, *, n_replicas=1, steal=False, model="m", **serve_kw):
    reg = ModelRegistry()
    reg.register(model, engine)
    cfg = TierConfig(n_replicas=n_replicas, steal=steal, warmup=False,
                     serve=ServeConfig(max_batch=8, max_delay_ms=1.0,
                                       warmup=False, **serve_kw))
    return ServeTier(reg, cfg)


def _row(k):
    return np.full(4, k, np.int64)


# --------------------------------------------------------------------------- #
# real models: parity with the reference, serve() over bundles, hot-swap
# --------------------------------------------------------------------------- #
def _port_stack(dims, seed):
    layers = build_lut_stack(list(dims), 4, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    return compile_sequential(layers, 4, 2)


def _ref_pid():
    from repro.core.lower import lower
    from repro.models.pid import (build_pid_graph, build_pid_layers,
                                  init_pid_params)

    layers = build_pid_layers(hidden=4)
    params = init_pid_params(layers, jax.random.PRNGKey(5))
    return lower(build_pid_graph(layers, n_samples=40), [*params, None])


@pytest.fixture(scope="module")
def models():
    """name -> (port program, reference program), the same arrays."""
    a = _port_stack((16, 20, 5), 0)
    pid = _ref_pid()
    return {"jsc": (a, RefDaisProgram.from_arrays(a.to_arrays())),
            "pid": (DaisProgram.from_arrays(pid.to_arrays()), pid)}


def _traffic(models, n, seed):
    rng = np.random.default_rng(seed)
    codes, refs = {}, {}
    for name, (prog, ref) in models.items():
        lo, hi = input_code_bounds(prog)
        codes[name] = rng.integers(lo, hi + 1, (n, len(lo)), np.int64)
        refs[name] = ref.run(codes[name])
    return codes, refs


@pytest.mark.parametrize("steal", [True, False])
def test_tier_parity_with_the_reference(models, steal):
    n = 48
    codes, refs = _traffic(models, n, seed=9)
    order = [(name, k) for k in range(n) for name in models]     # interleaved
    cfg = dict(max_batch=8, max_delay_ms=1.0)
    port = tier_from_built(
        {name: build(p, EngineSpec(engine="pallas", n_random=64), device="cpu")
         for name, (p, _r) in models.items()},
        TierConfig(n_replicas=2, steal=steal, serve=ServeConfig(**cfg)), start=False)
    with port:
        futs = [port.submit(codes[name][k], name) for name, k in order]
        got = [f.result(timeout=WAIT) for f in futs]
    ref = ref_api.tier_from_built(
        {name: ref_api.build(r, ref_api.EngineSpec(n_random=64))
         for name, (_p, r) in models.items()},
        ref_tier.TierConfig(n_replicas=2, steal=steal, serve=RefServeConfig(**cfg)),
        start=False)
    with ref:
        rfuts = [ref.submit(codes[name][k], name) for name, k in order]
        want = [np.asarray(f.result(timeout=WAIT), np.int64) for f in rfuts]
    for (name, k), g, w in zip(order, got, want):
        np.testing.assert_array_equal(g.astype(np.int64), w)
        np.testing.assert_array_equal(g.astype(np.int64), refs[name][k])
    s, rs = port.stats(), ref.stats()
    assert s.per_model == rs.per_model == {"jsc": n, "pid": n}
    assert s.n_requests == 2 * n and sum(s.per_replica_batches) == s.n_batches
    assert s.mean_batch_fill <= 8 and (s.n_stolen == 0 or steal)


def test_serve_bundles_and_hot_swap_under_load(models, tmp_path):
    """``serve()`` over bundle paths; mid-load, "jsc" is swapped for its
    DCE'd engine (same outputs): every request is answered bit for bit and
    the retired engine is never run after its lease drained."""
    paths = {}
    for name, (prog, _ref) in models.items():
        paths[name] = str(tmp_path / f"{name}.npz")
        gate = build(prog, EngineSpec(engine="pallas", n_random=64),
                     device="cpu").attestation
        save_artifact(paths[name], prog, attestation=gate)
    n = 96
    codes, refs = _traffic(models, n, seed=11)
    spec = EngineSpec(engine="pallas", require="pallas", verify="cached")
    tier = serve(paths, spec, TierConfig(n_replicas=2, serve=ServeConfig(
        max_batch=16, max_delay_ms=1.0)), device="cpu")
    info = tier.registry.info("jsc")
    assert isinstance(info, ModelInfo) and info.engine_path == "pallas"
    assert info.content_hash is not None and info.version == 1
    old = tier.registry.acquire("jsc")
    tier.registry.release(old)
    runs_after_close = []
    real_run = old.engine._runner

    def tracked(x):
        if getattr(old.engine, "closed", False):
            runs_after_close.append(x.shape[0])
        return real_run(x)

    old.engine._runner = tracked
    old.engine.close = lambda: setattr(old.engine, "closed", True)
    dce = build(models["jsc"][0], EngineSpec(engine="pallas", optimize=True,
                                             n_random=64), device="cpu")
    try:                                        # serve() started the tier
        futs = []
        for k in range(n):
            if k == n // 2:
                assert tier.registry.swap("jsc", dce.engine, dce.prog) == 2
            futs += [("jsc", k, tier.submit(codes["jsc"][k], "jsc")),
                     ("pid", k, tier.submit(codes["pid"][k], "pid"))]
        for name, k, f in futs:
            np.testing.assert_array_equal(
                np.asarray(f.result(timeout=WAIT), np.int64), refs[name][k])
    finally:
        tier.stop()
    assert old.engine.closed and not runs_after_close
    assert tier.registry.draining() == 0 and tier.registry.info("jsc").version == 2
    s = tier.stats()
    assert s.per_model == {"jsc": n, "pid": n} and s.n_requests == 2 * n


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
def test_registry_publish_swap_and_lease_drain():
    reg = ModelRegistry()
    a, b = EchoEngine(1), EchoEngine(2)
    assert reg.register("m", a, content_hash="ha") == 1
    assert reg.register("m", a, content_hash="ha") == 1      # idempotent
    with pytest.raises(RegistryError, match="replace"):
        reg.register("m", b, content_hash="hb")
    assert "m" in reg and len(reg) == 1 and reg.names() == ["m"]
    assert reg.info("m").content_hash == "ha"
    lease = reg.acquire("m")
    assert reg.swap("m", b, content_hash="hb") == 2
    assert not a.closed and reg.draining() == 1
    lease_b = reg.acquire("m")
    assert lease_b.engine is b
    reg.release(lease_b)
    reg.release(lease)
    assert a.closed and reg.draining() == 0
    reg.unregister("m")
    assert b.closed and "m" not in reg
    for call in (reg.acquire, reg.unregister, reg.info):
        with pytest.raises(RegistryError):
            call("m")


# --------------------------------------------------------------------------- #
# submit validation, lifecycle
# --------------------------------------------------------------------------- #
def test_tier_submit_validates_model_and_shape():
    reg = ModelRegistry()
    reg.register("a", EchoEngine(1))
    reg.register("b", EchoEngine(2, n_inputs=6))
    tier = ServeTier(reg, TierConfig(n_replicas=1, warmup=False,
                                     serve=ServeConfig(warmup=False)))
    with pytest.raises(RuntimeError, match="not running"):
        tier.submit(_row(0), "a")
    with tier:
        with pytest.raises(ValueError, match="model= is required"):
            tier.submit(_row(0))
        with pytest.raises(RegistryError):
            tier.submit(_row(0), "nope")
        with pytest.raises(ValueError, match="codes"):
            tier.submit(np.zeros(3, np.int64), "a")
        f = tier.submit(np.arange(6, dtype=np.int64), "b")
        np.testing.assert_array_equal(f.result(timeout=WAIT), np.arange(6) * 10 + 2)
    with pytest.raises(RuntimeError, match="already started"):
        with _tier(EchoEngine()) as t:
            t.start()
    with pytest.raises(ValueError, match="n_replicas"):
        TierConfig(n_replicas=0)


def test_single_model_needs_no_name():
    with _tier(EchoEngine(tag=3)) as tier:
        f = tier.submit(np.ones(4, np.int64))
        np.testing.assert_array_equal(f.result(timeout=WAIT), np.ones(4) * 10 + 3)
    s = tier.stats()
    assert isinstance(s, TierStats)
    assert s.n_requests == 1 and s.per_model == {"m": 1}
    assert s.as_dict()["n_requests"] == 1


# --------------------------------------------------------------------------- #
# admission
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["reject", "shed-oldest"])
def test_admission_at_the_bound(policy):
    """reject: submits past the bound raise; shed-oldest: the globally
    oldest queued request fails instead.  The request in flight is served."""
    eng = GateEngine()
    with _tier(eng, max_queue=3, overload_policy=policy) as tier:
        gate = tier.submit(_row(0))
        assert eng.entered.wait(timeout=WAIT)       # in flight, not queued
        a, b = tier.submit(_row(1)), tier.submit(_row(2))
        if policy == "reject":
            with pytest.raises(RejectedError, match="overload_policy='reject'"):
                tier.submit(_row(3))
            served = [(gate, 0), (a, 1), (b, 2)]
        else:
            c = tier.submit(_row(3))                # bound hit: sheds a
            with pytest.raises(RejectedError, match="shed"):
                a.result(timeout=WAIT)
            served = [(gate, 0), (b, 2), (c, 3)]
        eng.release.set()
        for f, v in served:
            np.testing.assert_array_equal(f.result(timeout=WAIT), _row(v) * 10)
    s = tier.stats()
    assert s.n_requests == 3
    assert (s.n_rejected, s.n_shed) == ((1, 0) if policy == "reject" else (0, 1))


def test_shed_with_nothing_queued_rejects_the_newcomer():
    eng = GateEngine()
    with _tier(eng, max_queue=1, overload_policy="shed-oldest") as tier:
        gate = tier.submit(np.zeros(4, np.int64))
        assert eng.entered.wait(timeout=WAIT)
        with pytest.raises(RejectedError, match="nothing left to shed"):
            tier.submit(np.ones(4, np.int64))
        eng.release.set()
        gate.result(timeout=WAIT)


# --------------------------------------------------------------------------- #
# work stealing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("steal", [True, False])
def test_stealing_from_the_deepest_queue(steal, monkeypatch):
    """Replica 0 is held on its first batch with 8 more requests queued
    behind it (routing pinned to replica 0): with stealing, replica 1 serves
    some of them before replica 0 is released; without, replica 1 serves
    none."""
    eng = GateEngine(n_gated=1)
    reg = ModelRegistry()
    reg.register("m", eng)
    cfg = TierConfig(n_replicas=2, steal=steal, warmup=False,
                     serve=ServeConfig(max_batch=4, max_delay_ms=1.0, warmup=False))
    tier = ServeTier(reg, cfg)
    monkeypatch.setattr(tier, "_route_locked", lambda: 0)
    with tier:
        probe = tier.submit(np.zeros(4, np.int64))
        assert eng.entered.wait(timeout=WAIT)       # replica 0 blocked in run()
        futs = [tier.submit(_row(k)) for k in range(1, 9)]
        if steal:                                   # the oldest are stolen first
            np.testing.assert_array_equal(futs[0].result(timeout=WAIT), _row(10))
            assert not probe.done()
        eng.release.set()
        for k, f in enumerate(futs, start=1):
            np.testing.assert_array_equal(f.result(timeout=WAIT), _row(k * 10))
        probe.result(timeout=WAIT)
    s = tier.stats()
    assert s.n_requests == 9
    assert (s.n_stolen > 0 and s.per_replica_batches[1] > 0) == steal
    assert (s.n_stolen == 0 and s.per_replica_batches[1] == 0) == (not steal)


# --------------------------------------------------------------------------- #
# deadline buckets
# --------------------------------------------------------------------------- #
def test_soonest_deadline_bucket_is_served_first():
    order = []

    class OrderEngine(EchoEngine):
        def run(self, x):
            order.append(self.tag)
            return super().run(x)

    gate = GateEngine(tag=0)
    reg = ModelRegistry()
    reg.register("gate", gate)
    reg.register("late", OrderEngine(1))
    reg.register("soon", OrderEngine(2))
    cfg = TierConfig(n_replicas=1, warmup=False,
                     serve=ServeConfig(max_batch=8, max_delay_ms=1.0, warmup=False))
    with ServeTier(reg, cfg) as tier:
        g = tier.submit(np.zeros(4, np.int64), "gate")
        assert gate.entered.wait(timeout=WAIT)      # the queue builds behind it
        f_late = tier.submit(np.ones(4, np.int64), "late")               # no deadline
        f_soon = tier.submit(np.ones(4, np.int64), "soon", deadline_ms=5.0)
        gate.release.set()
        for f in (f_soon, f_late, g):
            f.result(timeout=WAIT)
    assert order == [2, 1]
    assert tier.stats().n_requests == 3


def test_deadline_misses_are_counted():
    eng = GateEngine()
    with _tier(eng, slo_ms=1.0) as tier:           # every request misses
        f = tier.submit(np.zeros(4, np.int64))
        assert eng.entered.wait(timeout=WAIT)
        time.sleep(0.002)                           # past the 1 ms SLO
        eng.release.set()
        f.result(timeout=WAIT)
    assert tier.stats().deadline_misses == 1


# --------------------------------------------------------------------------- #
# hot-swap under load
# --------------------------------------------------------------------------- #
def test_hot_swap_under_load_never_serves_a_torn_down_engine():
    engines = [EchoEngine(tag) for tag in (1, 2, 3)]
    reg = ModelRegistry()
    reg.register("m", engines[0], content_hash="h1")
    cfg = TierConfig(n_replicas=2, warmup=False,
                     serve=ServeConfig(max_batch=8, max_delay_ms=0.5, warmup=False))
    results, stop = [], threading.Event()
    lock = threading.Lock()
    seen = {tag: threading.Event() for tag in (11, 12, 13)}

    def hammer():
        while not stop.is_set():
            try:
                f = tier.submit(np.ones(4, np.int64), "m")
            except RuntimeError:
                break
            v = int(np.asarray(f.result(timeout=WAIT))[0])
            with lock:
                results.append(v)
            seen[v].set()

    with ServeTier(reg, cfg) as tier:
        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        assert seen[11].wait(timeout=WAIT)
        reg.swap("m", engines[1], content_hash="h2")
        assert seen[12].wait(timeout=WAIT)
        reg.swap("m", engines[2], content_hash="h3")
        assert seen[13].wait(timeout=WAIT)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    assert set(results) == {11, 12, 13}
    assert all(e.runs_after_close == 0 for e in engines)
    assert engines[0].closed and engines[1].closed and not engines[2].closed
    assert reg.draining() == 0
    assert tier.stats().per_model["m"] == len(results)
