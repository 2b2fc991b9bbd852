"""The port's Pareto launcher (``launch/pareto.py``) and example
(``examples/pareto_sweep.py``) against the reference's, on the CPU.

* ``_snapshot_steps`` over a grid, and the launcher's validation errors,
  equal to the reference's;
* a β-ramped training run of 12 steps at B = 64 through the launcher's
  ``train_snapshots`` (snapshots at 4, 8 and 12, chunks of 8) against the
  reference's ``chunked_train`` with the same ramp and saves: the port's
  run equals its own per-step walk bit for bit, and the reference's within
  the bounds of ``tests/test_torch_train.py`` (ROADMAP C6), whose helpers
  it imports; the manifests' steps equal and their β within the float32
  ulps ``test_beta_schedule_values`` allows;
* ``measure_point`` on parameters crossed from the reference with cells
  pruned to zero bits (``tests/test_opt.py``'s surgery): program, DCE
  report, EBOPs, LUT estimate, widths and live-table stats equal to the
  same steps through the reference's public functions;
* the reference launcher's ``--smoke`` JSON (run once, in a module fixture,
  as ``tests/test_launchers.py`` runs it): ``select_frontier`` over its
  points gives its ``on_frontier`` flags and ``selected_step``, and the
  port's ``--smoke --device cpu`` JSON has its key sets;
* the example's smoke run.
"""

import copy
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as RefStore
from repro.core import ebops as ref_ebops
from repro.core.analysis import analyze_ranges as ref_analyze_ranges
from repro.core.dais import compile_sequential as ref_compile_sequential
from repro.core.opt import eliminate_dead_cells as ref_dce
from repro.core.tables import extract_tables as ref_extract_tables
from repro.launch import pareto as ref_pareto
from repro.launch.lint import live_table_stats as ref_live_table_stats
from repro.optim import adam as ref_adam
from repro.train import loop as ref_loop
from repro.train.steps import make_lut_train_step as ref_make_step
from repro_torch import interop
from repro_torch.ckpt.store import CheckpointStore
from repro_torch.core import ebops as port_ebops
from repro_torch.launch import pareto
from repro_torch.optim import adam as port_adam
from repro_torch.train.steps import TrainHParams, make_lut_train_step
from test_opt import _prune_in, _prune_out, _zero_cells

import test_torch_train as tt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
RAMP_STEPS = 12
SNAPS = [4, 8, 12]
BETA_RTOL = 2e-6        # float32 exp/log ulps, as test_beta_schedule_values


# --------------------------------------------------------------------------- #
# settings
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("steps", [1, 3, 7, 60, 100, 1499, 1500, 2500])
@pytest.mark.parametrize("n", [1, 3, 8, 10])
def test_snapshot_steps_equal_reference(steps, n):
    assert pareto._snapshot_steps(steps, n) == ref_pareto._snapshot_steps(steps, n)


def _args(module, argv):
    return module.build_argparser().parse_args(argv)


def _exit_message(fn):
    with pytest.raises(SystemExit) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("argv", [
    ["--steps", "0"], ["--batch", "-1"], ["--chunk-steps", "0"],
    ["--beta-final", "0"], ["--beta-init", "0"], ["--beta-init", "-1e-7"],
    ["--snapshots", "2"], ["--steps", "2", "--snapshots", "3"],
    ["--smoke", "--snapshots", "0"], ["--dims", "16"]],
    ids=lambda a: " ".join(a))
def test_validation_errors_equal_reference(argv):
    want = _exit_message(lambda: ref_pareto.run(_args(ref_pareto, argv)))
    got = _exit_message(lambda: pareto.run(_args(pareto, argv)))
    assert got == want


def test_used_checkpoint_dir_refused_as_the_reference(tmp_path):
    store = CheckpointStore(str(tmp_path))
    np.savez(os.path.join(tmp_path, "step_0000000007.npz"), a=np.zeros(1))
    argv = ["--smoke", "--ckpt-dir", str(tmp_path), "--out", ""]
    want = _exit_message(lambda: ref_pareto.run(_args(ref_pareto, argv)))
    got = _exit_message(lambda: pareto.run(_args(pareto, argv + ["--device", "cpu"])))
    assert got == want and "already contains checkpoints" in got and store.list_steps() == [7]


def test_flags_and_defaults_are_the_reference_plus_device():
    ref_ap, port_ap = ref_pareto.build_argparser(), pareto.build_argparser()
    ref_opts = {a.dest: a.default for a in ref_ap._actions}
    port_opts = {a.dest: a.default for a in port_ap._actions}
    assert set(port_opts) == set(ref_opts) | {"device"}
    assert port_opts["device"] == "cuda"
    assert port_opts["out"] == os.path.join("results", "pareto.json")
    assert ref_opts["out"] == "BENCH_pareto.json"
    assert {k: v for k, v in port_opts.items() if k not in ("device", "out")} == \
        {k: v for k, v in ref_opts.items() if k != "out"}
    cfg = pareto.resolve_settings(_args(pareto, []))
    assert (cfg.steps, cfg.batch, cfg.n_snap, cfg.n_train, cfg.n_eval, cfg.bench_batch,
            cfg.bench_rounds, cfg.n_requests, cfg.n_gate, cfg.max_batch) == \
        (1500, 1024, 8, 20000, 5000, 1024, 15, 1024, 1024, 64)
    cfg = pareto.resolve_settings(_args(pareto, ["--smoke"]))
    assert (cfg.steps, cfg.batch, cfg.n_snap, cfg.n_requests, cfg.max_batch) == \
        (60, 256, 3, 96, 16)


def test_quantized_inputs_equal_reference():
    x = np.random.default_rng(0).normal(0, 4, (300, 16)).astype(np.float32)
    got = pareto._quantize(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(ref_pareto._quantize(x), np.float32))


# --------------------------------------------------------------------------- #
# the β-ramped run with snapshots
# --------------------------------------------------------------------------- #
def _ramp_hparams():
    """``test_torch_train._hparams`` over 12 steps (the quickstart's Adam and
    cosine schedule), with the launcher's β ramp to 1e-3."""
    sched = dict(first_period=RAMP_STEPS // 2, warmup=min(30, RAMP_STEPS // 2))
    rhp = tt.RefHParams(adam=ref_adam.AdamConfig(lr=tt.LR),
                        beta=ref_ebops.BetaSchedule(5e-7, 1e-3, RAMP_STEPS),
                        lr_schedule=ref_adam.cosine_restarts(tt.LR, **sched))
    php = TrainHParams(adam=port_adam.AdamConfig(lr=tt.LR),
                       beta=port_ebops.BetaSchedule(5e-7, 1e-3, RAMP_STEPS),
                       lr_schedule=port_adam.cosine_restarts(tt.LR, **sched))
    return rhp, php


def _resynced_walk(params, rhp, php, batches):
    """The reference's einsum step over ``batches`` and, at every step, the
    port's step from the reference's state at that step (parameters and Adam
    state crossed as numpy, so the port's counter, β and learning rate are
    the step's): gradients and metrics within ``test_torch_train``'s
    one-step bounds.  Returns the elements whose gradient was noise at some
    step and the cell codes flipped on the way, as ``_walk_steps`` does."""
    from repro_torch.train.steps import lut_loss_and_grads

    ref_step, _ = ref_make_step(tt._ref_layers(), rhp, donate=False)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    ro = ref_adam.adam_init(rp)
    noisy, total_flips = {}, 0
    for s, (x, y) in enumerate(batches):
        rnp = jax.tree_util.tree_map(np.asarray, rp)
        layers = tt._port_layers(rnp)
        step_fn, _ = make_lut_train_step(layers, php)
        po = interop.opt_state_from_numpy(layers, jax.tree_util.tree_map(np.array, ro))
        assert int(po["step"]) == s
        batch_p = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
        n_flips = tt._n_flips(rnp, layers, x)
        total_flips += n_flips
        loss, ce, ebops, rg = tt._ref_loss_and_grads(rnp, x, y, rhp.beta, s)
        _, _, _, pg = lut_loss_and_grads(layers, php, po["step"], batch_p)
        tt._check_grads({k: g for k, g in pg.items() if k not in tt.ZERO_GRAD}, rg, n_flips)
        # the BN-shadowed bias's gradient is zero, and both packages' are
        # rounding noise (ROADMAP C6 a): below GRAD_RTOL of the layer's
        # largest gradient element, in each package
        for path in tt.ZERO_GRAD:
            scope = path.split("/")[0]
            scale = max(float(g.abs().max()) for k, g in pg.items() if k.startswith(scope + "/"))
            assert max(float(pg[path].abs().max()),
                       float(np.abs(tt._leaf(rg, path)).max())) <= tt.GRAD_RTOL * scale, path
        for path, g in pg.items():
            w = tt._leaf(rg, path)
            d = np.abs(g.numpy() - w)
            floor = tt.GRAD_RTOL * float(np.abs(w).max())
            bad = (d > 0) & ((np.abs(w) <= floor) | (d > tt.NOISE_REL * np.abs(w)))
            if path in tt.ZERO_GRAD:
                bad = np.ones_like(bad)
            noisy[path] = noisy.get(path, False) | bad
        rp, ro, rm = ref_step(rp, ro, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        _, pm = step_fn(po, batch_p)
        # against the reference's loss function, which its gradients come
        # from (its jitted step may round a cell to another code)
        want = dict(loss=loss, ce=ce, ebops=ebops, lr=float(rm["lr"]),
                    grad_norm=float(np.sqrt(sum(np.sum(np.square(np.asarray(g), dtype=np.float64))
                                                for g in jax.tree_util.tree_leaves(rg)))))
        tt._check_metrics(pm, want, n_flips)
    return noisy, total_flips


def test_beta_ramped_snapshots_match_reference(tmp_path):
    params = tt._ref_params(7)
    rhp, php = _ramp_hparams()
    batches = [tt._batch(40 + s) for s in range(RAMP_STEPS)]

    def get_batch(step):
        x, y = batches[step]
        return {"x": x, "y": y}

    noisy, total_flips = _resynced_walk(params, rhp, php, batches)

    # the reference: its chunked loop, a save at every snapshot (its launcher's loop)
    raw_step, _ = ref_make_step(tt._ref_layers(), rhp, jit=False)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    ro = ref_adam.adam_init(rp)
    ref_store = RefStore(str(tmp_path / "ref"), keep=len(SNAPS) + 1)
    ref_k = []
    for res in ref_loop.chunked_train(raw_step, rp, ro, get_batch, 0, RAMP_STEPS,
                                      chunk_steps=8, boundaries=SNAPS, prefetch=False):
        rp, ro = res.params, res.opt_state
        ref_k.append(res.k)
        end = res.step + res.k
        if end in SNAPS:
            ref_store.save(end, rp, extra={"beta": float(rhp.beta(end - 1)), "step": end},
                           blocking=True)

    layers = tt._port_layers(params)
    step_fn, init_fn = make_lut_train_step(layers, php)
    store = CheckpointStore(str(tmp_path / "port"), keep=len(SNAPS) + 1)
    chunks, opt = pareto.train_snapshots(step_fn, layers, init_fn(), get_batch, RAMP_STEPS, SNAPS,
                                    store=store, beta=php.beta, chunk_steps=8,
                                    prefetch=True)
    assert [c[1] for c in chunks] == ref_k == [4, 4, 4]
    assert [c[4] for c in chunks] == [True, False, False]
    assert store.list_steps() == ref_store.list_steps() == SNAPS

    # the port's chunked run is its per-step loop, bit for bit
    import test_torch_train_loop as tl
    walk_layers = tt._port_layers(params)
    walk_fn, walk_init = make_lut_train_step(walk_layers, php)
    walk_opt = walk_init()
    for s in range(RAMP_STEPS):
        walk_opt, _ = walk_fn(walk_opt, {k: torch.as_tensor(v) for k, v in get_batch(s).items()})
    assert tl._state_bytes(layers, opt) == tl._state_bytes(walk_layers, walk_opt)
    # and the reference's within C6's bounds
    tt._check_final_state(layers, opt, rp, ro, noisy, total_flips, RAMP_STEPS)

    ref_ps = jax.tree_util.tree_map(np.asarray, params)
    betas, weights = [], []
    for snap in SNAPS:
        snap_layers = copy.deepcopy(layers)
        _, _, manifest = store.restore(snap_layers, step=snap)
        _, _, ref_manifest = ref_store.restore(ref_ps, step=snap)
        assert manifest["step"] == ref_manifest["step"] == snap
        np.testing.assert_allclose(manifest["beta"], ref_manifest["beta"], rtol=BETA_RTOL)
        assert manifest["beta"] == float(np.float32(manifest["beta"]))
        assert manifest["beta"] == pareto.beta_used(php.beta, snap - 1, "cpu")
        betas.append(manifest["beta"])
        weights.append(snap_layers[1].w0.detach().numpy().copy())
    assert betas == sorted(betas) and len(set(betas)) == len(SNAPS)
    assert not np.array_equal(weights[0], weights[1])
    # the last snapshot is the trained state, the BN stats included
    assert tl._state_bytes(snap_layers, opt) == tl._state_bytes(layers, opt)


# --------------------------------------------------------------------------- #
# one snapshot through the hardware pipeline
# --------------------------------------------------------------------------- #
def _pruned_params(seed):
    rng = np.random.default_rng(seed)
    params = tt._ref_params(seed)
    p0 = jax.tree_util.tree_map(np.array, params["l0"])
    p1 = jax.tree_util.tree_map(np.array, params["l1"])
    p0 = _prune_out(p0, rng.random((16, 20)) < 0.3)
    p0 = _zero_cells(p0, rng.random((16, 20)) < 0.2)
    p1 = _prune_in(p1, rng.random((20, 5)) < 0.3)
    p1 = _prune_out(p1, np.eye(20, 5, dtype=bool))
    return {k: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
            for k, p in (("l0", p0), ("l1", p1))}


@pytest.mark.parametrize("seed", [3, 11])
def test_measure_point_equals_reference_steps(seed):
    params = _pruned_params(seed)
    ref_layers = tt._ref_layers()
    ref_list = [params["l0"], params["l1"]]
    tables = [ref_extract_tables(layer, jax.tree_util.tree_map(jnp.asarray, p))
              for layer, p in zip(ref_layers, ref_list)]
    ebops = float(sum(ref_ebops.ebops_lut_np(t.in_width, t.out_width) for t in tables))
    prog = ref_compile_sequential(ref_layers, ref_list, pareto.IN_F, pareto.IN_I)
    opt_prog, rep = ref_dce(prog)
    ranges = ref_analyze_ranges(opt_prog)
    live = ref_live_table_stats(opt_prog, ranges) or {}

    layers = tt._port_layers(params)
    for layer in layers:
        layer.eval()
    x, y = tt._batch(seed, n=96)
    data = (torch.as_tensor(x), torch.as_tensor(y))
    point, (p_opt, gate, p_prog, engine) = pareto.measure_point(
        layers, step=5, beta=1e-4, val=data, test=data, engine="pallas", n_gate=64,
        bench_batch=16, bench_rounds=1, seed=0)

    for got, want in ((p_prog, prog), (p_opt, opt_prog)):
        a, b = got.to_arrays(), want.to_arrays()
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert rep.n_llut_after < rep.n_llut_before           # pruning left DCE work
    gw0, gw1 = rep.total_gather_width()
    assert point["ebops"] == ebops and point["est_luts"] == ref_ebops.estimate_luts(ebops)
    assert (point["n_llut"], point["n_llut_live"], point["gather_width"],
            point["gather_width_dce"], point["n_instrs"], point["n_instrs_dce"]) == \
        (rep.n_llut_before, rep.n_llut_after, gw0, gw1, rep.n_instrs_before,
         rep.n_instrs_after)
    assert (point["required_width"], point["proven_width"], point["engine_width"]) == \
        (opt_prog.required_width(), ranges.proven_width(), ranges.engine_width())
    assert {k: point[k] for k in live} == live and live
    assert point["engine_path"] == engine.path == "pallas"
    assert point["verify"] == gate and gate["random"] == 64
    assert point["val_acc"] == point["test_acc"] and 0.0 <= point["val_acc"] <= 1.0
    assert point["engine_us"] > 0 and point["bench_batch"] == 16
    json.dumps(point)                                      # plain Python numbers


# --------------------------------------------------------------------------- #
# the launchers' JSON
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_smoke(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_pareto")
    out = str(tmp / "pareto.json")
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.pareto", "--smoke", "--out", out,
         "--ckpt-dir", str(tmp / "ckpt"), "--serve-requests", "48"],
        env=ENV, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out) as fh:
        return json.load(fh)


def test_select_frontier_reproduces_reference_selection(ref_smoke):
    points = [{k: v for k, v in p.items() if k != "on_frontier"} for p in ref_smoke["points"]]
    frontier, top, selected = pareto.select_frontier(points, ref_smoke["select_tol"])
    assert [p["on_frontier"] for p in points] == \
        [p["on_frontier"] for p in ref_smoke["points"]]
    assert selected["step"] == ref_smoke["selected_step"]
    assert top["val_acc"] == max(p["val_acc"] for p in points)
    assert frontier == [p for p in sorted(points, key=lambda p: (p["est_luts"], -p["val_acc"]))
                        if p["on_frontier"]]


@pytest.mark.parametrize("vals,luts,tol,want_flags,want_step", [
    ((0.5, 0.6, 0.7), (300.0, 200.0, 100.0), 0.02, [False, False, True], 3),
    ((0.7, 0.6, 0.5), (300.0, 200.0, 100.0), 0.02, [True, True, True], 1),
    ((0.7, 0.69, 0.5), (300.0, 200.0, 100.0), 0.02, [True, True, True], 2),
    ((0.7, 0.7, 0.7), (100.0, 100.0, 100.0), 0.0, [True, False, False], 1)])
def test_select_frontier_cases_equal_reference_rule(vals, luts, tol, want_flags, want_step):
    points = [{"step": k + 1, "val_acc": v, "est_luts": c}
              for k, (v, c) in enumerate(zip(vals, luts))]
    _, _, selected = pareto.select_frontier(points, tol)
    assert [p["on_frontier"] for p in points] == want_flags
    assert selected["step"] == want_step


def test_port_smoke_json_has_the_reference_keys(ref_smoke, tmp_path, capsys):
    out = str(tmp_path / "pareto.json")
    payload = pareto.run(_args(pareto, ["--smoke", "--device", "cpu", "--engine", "pallas",
                                        "--out", out, "--ckpt-dir", str(tmp_path / "ckpt"),
                                        "--serve-requests", "48"]))
    with open(out) as fh:
        written = json.load(fh)
    assert written == payload
    assert set(payload) == set(ref_smoke)
    assert set(payload["serve"]) == set(ref_smoke["serve"])
    for key in ("engine", "tier"):
        assert set(payload["serve"][key]) == set(ref_smoke["serve"][key])
    for got, want in zip(payload["points"], ref_smoke["points"]):
        assert set(got) == set(want)
        assert set(got["verify"]) == set(want["verify"])
    assert [p["step"] for p in payload["points"]] == [p["step"] for p in ref_smoke["points"]]
    assert all(p["engine_path"] == "pallas" and p["verify"]["random"] > 0
               for p in payload["points"])
    assert os.path.exists(payload["serve"]["bundle"]) and payload["serve"]["bundle_kept"]
    assert "served 48 requests" in capsys.readouterr().out


def test_example_smoke_runs_on_cpu(capsys):
    from repro_torch.examples import pareto_sweep

    res = pareto_sweep.main(["--device", "cpu", "--smoke"])
    assert res["steps"] == 30 and len(res["snapshots"]) == 10
    betas = [s[1] for s in res["snapshots"]]
    assert betas == sorted(betas) and betas[-1] == pytest.approx(1.5e-4, rel=1e-5)
    assert res["pareto"] and "Pareto points" in capsys.readouterr().out


def test_launcher_needs_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    msg = _exit_message(lambda: pareto.run(_args(pareto, ["--smoke"])))
    assert "no CUDA device" in msg
    from repro_torch.examples import pareto_sweep
    assert "no CUDA device" in _exit_message(lambda: pareto_sweep.main(["--smoke"]))


def test_module_entry_point_runs(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pareto", "--smoke", "--device", "cpu",
         "--steps", "9", "--serve-requests", "0", "--out", str(tmp_path / "p.json")],
        env=ENV, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "frontier:" in r.stdout and "temp snapshot dir removed" in r.stdout
    with open(tmp_path / "p.json") as fh:
        assert json.load(fh)["serve"] is None
