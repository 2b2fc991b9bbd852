"""Port parity for the chunked training loop (``train/loop.py``) and its
input pipeline (``data/pipeline.py``), on the contract of the reference's
``tests/test_train_loop.py``.

The load-bearing claim, as in the reference: grouping the port's optimizer
steps into chunks and moving batch synthesis onto the prefetch thread change
not one bit of the parameters, the Adam state or the BN stats against the
per-step loop, across mixed chunk lengths and grouping choices.  On the CPU
a chunk runs eagerly (graph mode needs a CUDA device and says so); the
graph's bits are held on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Against the JAX package: ``plan_chunks`` and
``stack_batches`` give the reference's values, and the port's
``run_chunked`` matches the reference's ``run_chunked`` within the
tolerances of ``tests/test_torch_train.py``.
"""

import itertools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as ref_pipeline
from repro.optim import adam as ref_adam
from repro.train import loop as ref_loop
from repro.train.steps import make_lut_train_step as ref_make_step
from repro_torch import interop
from repro_torch.core.ebops import BetaSchedule
from repro_torch.core.lut_layers import LUTDense
from repro_torch.data.pipeline import HostPrefetcher, chunk_stream, stack_batches
from repro_torch.optim.adam import AdamConfig, cosine_restarts
from repro_torch.train.loop import (chunked_train, make_chunked_step, plan_chunks,
                                    run_chunked)
from repro_torch.train.steps import TrainHParams, make_lut_train_step, named_params

torch.set_num_threads(2)

CPU = torch.device("cpu")


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("start,stop,chunk,bounds,want", [
    (0, 20, 8, (), [(0, 8), (8, 8), (16, 4)]),
    (0, 12, 4, (6, 7), [(0, 4), (4, 2), (6, 1), (7, 4), (11, 1)]),
    (5, 9, 10, (0, 5, 9, 40), [(5, 4)]),
    (5, 12, 4, (3, 6, 9), [(5, 1), (6, 3), (9, 3)]),
    (5, 5, 4, (), []),
])
def test_plan_chunks_reference_cases(start, stop, chunk, bounds, want):
    got = plan_chunks(start, stop, chunk, boundaries=bounds)
    assert got == ref_loop.plan_chunks(start, stop, chunk, boundaries=bounds) == want


GRID = list(itertools.product((0, 3, 17), (0, 1, 25), (1, 4, 8, 40),
                              ((), (5,), (10, 11, 30), (0, 100))))


@pytest.mark.parametrize("start,length,chunk,bounds", GRID)
def test_plan_chunks_equals_reference(start, length, chunk, bounds):
    stop = start + length
    got = plan_chunks(start, stop, chunk, boundaries=bounds)
    assert got == ref_loop.plan_chunks(start, stop, chunk, boundaries=bounds)
    step = start
    for s, k in got:                    # exact cover, no boundary crossed
        assert s == step and 1 <= k <= chunk
        assert not any(s < b < s + k for b in bounds)
        step += k
    assert step == stop


def test_plan_chunks_validates():
    for fn in (plan_chunks, ref_loop.plan_chunks):
        with pytest.raises(ValueError, match="chunk_steps"):
            fn(0, 10, 0)
        with pytest.raises(ValueError, match="empty"):
            fn(10, 5, 4)


# ------------------------------------------------------------- prefetcher
def _toy_get_batch(step: int) -> dict:
    rng = np.random.default_rng([11, step])
    return {"x": rng.normal(0, 1, (4, 3)).astype(np.float32),
            "y": np.full((4,), step, np.int32)}


def test_stack_batches_equals_reference():
    got = stack_batches(_toy_get_batch, 2, 3)
    want = ref_pipeline.stack_batches(_toy_get_batch, 2, 3)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["x"].shape == (3, 4, 3)
    np.testing.assert_array_equal(got["y"][:, 0], [2, 3, 4])
    with pytest.raises(ValueError, match="chunk length"):
        stack_batches(_toy_get_batch, 0, 0)


def test_prefetch_chunks_bit_identical_to_sync():
    segs = plan_chunks(0, 13, 4, boundaries=[6])
    sync = list(chunk_stream(_toy_get_batch, segs, prefetch=False, device=CPU))
    pre = list(chunk_stream(_toy_get_batch, segs, prefetch=True, device=CPU))
    ref = list(ref_pipeline.chunk_stream(_toy_get_batch, segs, prefetch=False))
    assert [(s, k) for s, k, _ in sync] == [(s, k) for s, k, _ in pre] == segs
    for (_, _, a), (_, _, b), (_, _, r) in zip(sync, pre, ref):
        for key in a:
            assert a[key].device == CPU
            assert a[key].numpy().tobytes() == b[key].numpy().tobytes()
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(r[key]))


def test_prefetcher_preserves_stateful_rng_order():
    """A stateful host RNG drawn once per get_batch must see the same call
    order on the worker thread."""
    def make(seed):
        rng = np.random.default_rng(seed)
        return lambda step: {"idx": rng.integers(0, 1000, 8)}

    segs = plan_chunks(0, 10, 3)
    sync = list(chunk_stream(make(5), segs, prefetch=False, device=CPU))
    pre = list(chunk_stream(make(5), segs, prefetch=True, device=CPU))
    for (_, _, a), (_, _, b) in zip(sync, pre):
        np.testing.assert_array_equal(a["idx"].numpy(), b["idx"].numpy())


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "host-prefetch"]


def test_prefetcher_clean_shutdown_mid_stream():
    """Abandoning the stream early leaks no thread and no queued chunk."""
    segs = plan_chunks(0, 40, 2)
    pf = HostPrefetcher(_toy_get_batch, segs, depth=2, device=CPU)
    it = iter(pf)
    next(it)
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.qsize() == 0
    pf.close()                     # idempotent
    assert not _prefetch_threads()


def test_chunk_stream_generator_abandonment_joins_worker():
    segs = plan_chunks(0, 40, 2)
    gen = chunk_stream(_toy_get_batch, segs, prefetch=True, device=CPU)
    next(gen)
    gen.close()                    # GeneratorExit -> context __exit__ -> close
    assert not _prefetch_threads()


def test_prefetcher_propagates_get_batch_error():
    def bad(step: int) -> dict:
        if step == 3:
            raise RuntimeError("synth failed at step 3")
        return _toy_get_batch(step)

    segs = plan_chunks(0, 10, 2)
    with pytest.raises(RuntimeError, match="synth failed"):
        list(chunk_stream(bad, segs, prefetch=True, device=CPU))
    assert not _prefetch_threads()
    with pytest.raises(ValueError, match="depth"):
        HostPrefetcher(_toy_get_batch, segs, depth=0, device=CPU)


def test_chunks_go_to_the_card_unless_the_cpu_is_asked_for():
    """``device=None`` means the card: without one the pipeline raises
    instead of handing over CPU tensors."""
    segs = plan_chunks(0, 4, 2)
    if torch.cuda.is_available():
        _, _, chunk = next(chunk_stream(_toy_get_batch, segs, prefetch=False))
        assert chunk["x"].device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            next(chunk_stream(_toy_get_batch, segs, prefetch=False))
        with pytest.raises((RuntimeError, AssertionError)):
            HostPrefetcher(_toy_get_batch, segs)


# --------------------------------------------------- chunked == per-step
DIMS, HIDDEN, BATCH = (6, 5, 3), 3, 16


def _port_setup(fused, total=20, seed=0):
    """A 6 -> 5 (BN) -> 3 stack with the quickstart's schedules; returns
    ``(layers, step_fn, init_fn)``."""
    hp = TrainHParams(adam=AdamConfig(lr=1e-3), beta=BetaSchedule(5e-7, 1e-4, total),
                      lr_schedule=cosine_restarts(1e-3, first_period=5, warmup=3),
                      lut_use_fused=fused)
    layers = [LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0), device="cpu",
                       generator=torch.Generator().manual_seed(seed + k))
              for k, (ci, co) in enumerate(zip(DIMS[:-1], DIMS[1:]))]
    step_fn, init_fn = make_lut_train_step(layers, hp)
    return layers, step_fn, init_fn


def _get_batch(step: int) -> dict:
    rng = np.random.default_rng([23, step])
    return {"x": rng.normal(0, 1, (BATCH, DIMS[0])).astype(np.float32),
            "y": rng.integers(0, DIMS[-1], BATCH).astype(np.int32)}


def _state_bytes(layers, opt) -> dict:
    """Parameters, BN stats and Adam state as bytes, by reference path."""
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


def _per_step(fused, steps):
    layers, step_fn, init_fn = _port_setup(fused)
    opt, rows = init_fn(), []
    for s in range(steps):
        opt, m = step_fn(opt, {k: torch.from_numpy(v) for k, v in _get_batch(s).items()})
        rows.append(m)
    return layers, opt, rows


@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_chunked_bit_exact_vs_per_step(fused):
    """Mixed chunk lengths and the prefetch thread against the per-step
    loop: every bit of the parameters, BN stats (layer 0) and Adam state."""
    steps = 11
    ref_layers, ref_opt, rows = _per_step(fused, steps)
    layers, step_fn, init_fn = _port_setup(fused)
    params, opt, metrics = run_chunked(step_fn, named_params(layers), init_fn(),
                                       _get_batch, 0, steps, chunk_steps=4,
                                       boundaries=[6], prefetch=True)
    assert params.keys() == named_params(layers).keys()
    assert _state_bytes(layers, opt) == _state_bytes(ref_layers, ref_opt)
    assert metrics["loss"].shape == (1,)       # the last chunk: step 10 alone
    for name, v in rows[-1].items():
        assert metrics[name].tobytes() == v.numpy().reshape(1).tobytes()


def test_chunk_grouping_invariance():
    """Chunking as 3s or 7s is launch granularity only: the same bits."""
    outs = []
    for chunk in (3, 7):
        layers, step_fn, init_fn = _port_setup(True)
        _, opt, _ = run_chunked(step_fn, named_params(layers), init_fn(), _get_batch,
                                0, 14, chunk_steps=chunk, prefetch=(chunk == 3))
        outs.append(_state_bytes(layers, opt))
    assert outs[0] == outs[1]


def test_chunked_train_yields_real_boundaries():
    layers, step_fn, init_fn = _port_setup(True)
    results = list(chunked_train(step_fn, named_params(layers), init_fn(), _get_batch,
                                 0, 10, chunk_steps=4, prefetch=False))
    assert [(r.step, r.k) for r in results] == [(0, 4), (4, 4), (8, 2)]
    # the first chunk of each k is the one that compiles (captures, on the card)
    assert [r.compiled for r in results] == [True, False, True]
    assert all(r.dt_s > 0 and 0 < r.host_s <= r.dt_s for r in results)
    for r in results:
        assert set(r.metrics) >= {"loss", "ce", "ebops"}
        assert r.metrics["loss"].shape == (r.k,)
        assert r.params is results[0].params   # the step trains it in place


def test_graph_mode_needs_a_cuda_device():
    """Graph mode on the CPU raises; nothing falls back to eager."""
    layers, step_fn, init_fn = _port_setup(True)
    with pytest.raises(ValueError, match="graph mode"):
        make_chunked_step(step_fn, mode="graph", device="cpu")
    with pytest.raises(ValueError, match="graph mode"):
        run_chunked(step_fn, named_params(layers), init_fn(), _get_batch, 0, 2,
                    mode="graph")
    with pytest.raises(ValueError, match="mode"):
        make_chunked_step(step_fn, mode="scan", device="cpu")


def test_step_without_commit_writes_nothing():
    """The graph capture's warm-up: the whole step, nothing written back."""
    layers, step_fn, init_fn = _port_setup(True)
    opt = init_fn()
    batch = {k: torch.from_numpy(v) for k, v in _get_batch(0).items()}
    before = _state_bytes(layers, opt)
    new_opt, m = step_fn(opt, batch, commit=False)
    assert _state_bytes(layers, opt) == before
    assert int(new_opt["step"]) == 1 and int(opt["step"]) == 0
    _, m2 = step_fn(opt, batch)
    assert _state_bytes(layers, opt) != before
    assert all(m[k].numpy().tobytes() == m2[k].numpy().tobytes() for k in m)


# ------------------------------------------------------- against the JAX package
@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_run_chunked_matches_reference_run_chunked(fused):
    """The port's ``run_chunked`` and the reference's (its raw einsum step
    scanned) over 3 steps in chunks of 2, from the same parameters, on the
    inputs of ``test_train_steps_match_reference_einsum_step`` (its batch at
    every step): within that test's tolerances, whose per-step walk of both
    packages gives the noisy elements; the port's chunked run equals its
    per-step walk bit for bit."""
    import test_torch_train as tt

    n_steps = 3
    params = tt._ref_params(5)
    rhp, php = tt._hparams(fused, n_steps)
    batches = [tt._batch(5)] * n_steps

    def get_batch(step):
        x, y = batches[step]
        return {"x": x, "y": y}

    _, _, walk_layers, walk_opt, noisy, total_flips, bn_shift = tt._walk_steps(
        params, rhp, php, batches)
    raw_step, _ = ref_make_step(tt._ref_layers(), rhp, jit=False)
    rp0 = jax.tree_util.tree_map(jnp.asarray, params)
    rp, ro, rm = ref_loop.run_chunked(raw_step, rp0, ref_adam.adam_init(rp0), get_batch,
                                      0, n_steps, chunk_steps=2, prefetch=False)
    layers = tt._port_layers(params)
    step_fn, init_fn = make_lut_train_step(layers, php)
    _, po, pm = run_chunked(step_fn, named_params(layers), init_fn(), get_batch, 0,
                            n_steps, chunk_steps=2)
    assert _state_bytes(layers, po) == _state_bytes(walk_layers, walk_opt)
    tt._check_final_state(layers, po, rp, ro, noisy, total_flips, n_steps, bn_shift)
    assert pm["loss"].shape == np.asarray(rm["loss"]).shape == (1,)
    tt._check_metrics({k: v[0] for k, v in pm.items()},
                      {k: np.asarray(v)[0] for k, v in rm.items()}, total_flips)
