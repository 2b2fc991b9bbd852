"""The plain references against the port on the CPU at small sizes: one
JSC-HLF train step (loss, gradients, the Adam update), and the PID
hybrid's integer forward at ctx 100 against ``DaisProgram.run`` of the
port's lowering.  The trace reduction on a hand-made trace."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.families import lut_stack, pid_hybrid
from bench.profiling import reduce_trace
from bench.reference import cepc_pid, jsc_hlf

ROOT = Path(__file__).resolve().parents[2]


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", [7, 2 ** 33 + 1])
def test_jsc_train_step_matches_the_port(seed):
    cfg = _cfg("jsc_hlf")
    params, state = lut_stack.init_params(cfg, seed, "cpu")
    params0 = {k: v.clone() for k, v in params.items()}
    layers, step_fn, trained, opt, b1 = lut_stack.build(cfg, params, state, "cpu")
    batch = lut_stack.Data(cfg, {"n_train": 2048, "batch": 256}, seed)(0)
    x, y = torch.from_numpy(batch["x"]).clone(), torch.from_numpy(batch["y"]).clone()
    opt, metrics = step_fn(opt, {"x": x, "y": y})
    ref = jsc_hlf.train(params0, state, cfg, [(x, y)])
    assert float(metrics["loss"]) == pytest.approx(ref["losses"][0], rel=1e-6)
    norms = {k: float(g.abs().max()) for k, g in ref["grads"].items()}
    med = float(np.median(list(norms.values())))
    lr = 3e-3 / 30                      # the first step's warmed-up rate
    for k, p in trained.items():
        g = opt["m"][k] / (1 - b1)
        assert float((g - ref["grads"][k]).abs().max()) <= 1e-4 * max(norms[k], med), k
        assert float((p.detach() - ref["state"][k]).abs().max()) <= 2 * lr + 1e-7, k
    for k, v in layers[0].named_buffers():
        torch.testing.assert_close(v, ref["state"][f"l0/{k}"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 11])
def test_pid_integer_forward_matches_dais_program(seed):
    from repro_torch.core.lower import lower
    from repro_torch.models import pid

    cfg = _cfg("cepc_pid")
    params = pid_hybrid.init_params(cfg, seed, "cpu")
    layers = pid.build_pid_layers(device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in pid.pid_named_params(layers).items():
            p.copy_(params[k])
    prog = lower(pid.build_pid_graph(layers, n_samples=100))
    codes = pid_hybrid.pool(cfg, {"pool_batches": 1, "batch": 48, "ctx": 100,
                                  "input_dtype": "int16"}, seed)[0]
    want = prog.run(codes.astype(np.int64))[:, 0]
    got = cepc_pid.forward(torch.as_tensor(codes), cepc_pid.prepare(params, cfg), cfg,
                           block=16).numpy()
    np.testing.assert_array_equal(got, want)
    ops = cepc_pid.chain_stages(cepc_pid.prepare(params, cfg), cfg, 100)
    assert [s["kind"] for s in ops] == ["mac", "lut", "lut", "lut", "sum"]


def test_requant_rounds_half_to_even():
    v = torch.tensor([-6, -5, -3, -2, -1, 1, 2, 3, 5, 6, 7])
    got = cepc_pid.requant(v, torch.tensor(2), torch.tensor(1))
    # v / 2 rounded half to even
    assert got.tolist() == [-3, -2, -2, -1, 0, 0, 1, 2, 2, 3, 4]


def test_reduce_trace_busy_idle_and_names():
    ev = [{"cat": "user_annotation", "name": "bench_window", "ts": 0.0, "dur": 100.0},
          {"cat": "kernel", "name": "k1", "ts": 10.0, "dur": 20.0},
          {"cat": "kernel", "name": "k2", "ts": 20.0, "dur": 20.0},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60.0, "dur": 50.0},
          {"cat": "cpu_op", "name": "outer", "ts": 0.0, "dur": 100.0},
          {"cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 41.0, "dur": 18.0}]
    r = reduce_trace(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(70e-6)         # 10-40 and 60-100
    assert r["ops"]["Memcpy HtoD"]["seconds"] == pytest.approx(40e-6)
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["outer"] == pytest.approx(10e-6)        # 0-10
    assert gaps["cudaGraphLaunch"] == pytest.approx(20e-6)   # 40-60
