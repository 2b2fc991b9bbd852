"""The check that decides ``correct`` fails where it must, on the CPU at
sizes a test run holds: the control (the plain reference one precision
down, in the program's place) fails a number of each cell, and a run
driven with the timed path broken underneath comes out not correct, once
for each fault a cell can have (a train step that leaves its state
unchanged, or drops half of each batch, and on a card a graph chunk
replayed on the rows it was captured with; a scored answer altered, or half
of a batch's answers never coming).  A run with nothing broken comes out
correct."""

import time
from pathlib import Path

import pytest
import torch

from bench import harness
from bench.kinds import score, train

ROOT = Path(__file__).resolve().parents[2]
SPEC = harness.load_spec(ROOT)
SMALL = {"jsc_hlf.train_b16600": {"batch": 512, "n_train": 4096},
         "jsc_hlf.train_b1024": {"batch": 512, "n_train": 4096},
         "cepc_pid.score_ctx3000": {"ctx": 100, "batch": 16, "pool_batches": 2,
                                    "trace_batches": 2}}


def _cell(name):
    cell = harness.resolve(SPEC, name, ROOT)
    cell["traffic_data"].update(SMALL[name])
    return cell


def _correct(cell, run):
    compared = harness.judge(run["numbers"], cell["limits"])
    return all(c["ok"] for c in compared.values()) and run["failed"] == 0


def _run(name, seed=2 ** 31 + 3, device="cpu"):
    cell = _cell(name)
    kw = ({"mode": "eager" if device == "cpu" else "graph"}
          if cell["traffic_data"]["kind"] == "train" else {})
    run = harness.kind(cell).run(cell, seed, 0.3, False, device, time.perf_counter(), **kw)
    return _correct(cell, run)


TRAIN = [n for n in SMALL if n.startswith("jsc_hlf.")]


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails_a_number(name):
    cell = _cell(name)
    tc = train.TrainCell({**cell, "seconds": 0}, 11, "cpu", "eager")
    try:
        tc.setup()
    finally:
        tc.close()
    ref = tc.reference()
    sound = harness.judge(tc.compare(ref), cell["limits"])
    control = harness.judge(tc.compare(ref, tc.reference(torch.bfloat16)), cell["limits"])
    assert sound["grad_gap"]["ok"]
    assert not all(c["ok"] for c in control.values())


def test_score_control_fails():
    cell = _cell("cepc_pid.score_ctx3000")
    sc = score.ScoreCell(cell, 11, "cpu")
    try:
        sc.setup()
        sc.loop(batches=3)
    finally:
        sc.close()
    exp = sc.expected()
    assert sc.wrong(exp) == (0, 0)
    ctl = sc.expected(torch.bfloat16)
    sc.outputs = [ctl[n % len(ctl)][:, None] for n in range(len(sc.outputs))]
    assert sc.wrong(exp)[0] > cell["limits"]["wrong_outputs"]


@pytest.mark.parametrize("name", TRAIN + ["cepc_pid.score_ctx3000"])
def test_sound_run_is_correct(name):
    assert _run(name)


def _wrap_step(monkeypatch, wrap):
    from repro_torch.train import steps

    orig = steps.make_lut_train_step

    def broken(layers, hp):
        step_fn, init_fn = orig(layers, hp)
        return wrap(step_fn), init_fn

    monkeypatch.setattr(steps, "make_lut_train_step", broken)


@pytest.mark.parametrize("name", TRAIN)
def test_step_leaving_state_unchanged_is_not_correct(monkeypatch, name):
    _wrap_step(monkeypatch, lambda f: lambda opt, batch, commit=True: f(opt, batch, commit=False))
    assert not _run(name)


@pytest.mark.parametrize("name", TRAIN)
def test_step_on_half_the_batch_is_not_correct(monkeypatch, name):
    def half(f):
        return lambda opt, batch, commit=True: f(
            opt, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, commit=commit)

    _wrap_step(monkeypatch, half)
    assert not _run(name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN)
def test_graph_chunk_replayed_on_its_captured_rows_is_not_correct(card, name):
    from bench.tools.faults import stale_graph_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    assert _run(name, device="cuda")
    with stale_graph_batches():
        assert not _run(name, device="cuda")


def _wrap_engine(monkeypatch, wrap):
    """Break ``ServeEngine.run`` from the window on (the program's own gate
    in set-up would refuse the engine before any window)."""
    from repro_torch.kernels import lut_serve

    orig_run, orig_loop = lut_serve.ServeEngine.run, score.ScoreCell.loop
    live = []

    def loop(self, *a, **kw):
        live.append(True)
        return orig_loop(self, *a, **kw)

    monkeypatch.setattr(score.ScoreCell, "loop", loop)
    monkeypatch.setattr(lut_serve.ServeEngine, "run",
                        lambda self, x: wrap(orig_run(self, x)) if live else orig_run(self, x))


def test_altered_answer_is_not_correct(monkeypatch):
    calls = []

    def alter(out):
        calls.append(1)
        if len(calls) == 2:
            out = out.clone()
            out[3, 0] += 1
        return out

    _wrap_engine(monkeypatch, alter)
    assert not _run("cepc_pid.score_ctx3000")


def test_half_of_the_answers_missing_is_not_correct(monkeypatch):
    _wrap_engine(monkeypatch, lambda out: out[: out.shape[0] // 2])
    assert not _run("cepc_pid.score_ctx3000")
