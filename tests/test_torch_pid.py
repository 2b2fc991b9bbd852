"""Port parity for the PID hybrid slice (paper §V-F): ``cepc_waveform``, the
hybrid's parameters carried across, its train steps, its lowering, its
serving engine, the example and the launcher, against the JAX package.

Small sizes: hidden 4, waveforms of 200 samples (10 windows), contexts of
40 and 60 samples.  The reference's train step is its example's
(``examples/pid_hybrid.py``: ``forward``, MSE + ``BETA``·EBOPs, Adam with
cosine restarts, jitted), assembled here from its parts because the example
builds it inside ``main``.  The lowering and the interpreter are the
reference's ``lower`` and ``DaisProgram.run``, never its launcher (ROADMAP
C2).

Tolerances, as ``test_torch_train.py``'s and for the same reasons:
* the front is exact in float32 on both sides (quantized products on a
  2^-12 grid, 20 terms); the LUT cells pass through each package's CPU
  ``tanh``, so a cell on a rounding boundary may take the neighbouring code
  (C6c).  Flipped cells are counted (at most ``FLIP_FRAC``); each may move
  the gradients by ``FLIP_ATOL``;
* otherwise gradients hold to ``GRAD_RTOL`` of their tensor's largest plus
  ``GRAD_ATOL``; loss, MSE and the global norm to ``rel=1e-5`` (1e-3 for the
  norm once a cell flipped); EBOPs to ``rel=1e-6``;
* Adam's first steps move a parameter by about ``sign(g)·lr``: an element
  whose gradient is within noise of 0 may land up to ``2·lr`` a step apart
  (C6b); those are counted and held to that bound, every other parameter
  and Adam moment to ``PARAM_ATOL`` plus 1e-3 of itself;
* integer artifacts are exact: program arrays, engine outputs.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_layers as ref_ll
from repro.core.dais import DaisProgram as RefDaisProgram
from repro.core.lower import lower as ref_lower
from repro.core.quant import fake_quant as ref_fake_quant
from repro.data.synthetic import cepc_waveform as ref_cepc_waveform
from repro.models import pid as ref_pid
from repro.optim import adam as ref_adam
from repro_torch import interop
from repro_torch.core import lower as port_lower
from repro_torch.core.tables import LayerTables, extract_tables
from repro_torch.data.synthetic import cepc_waveform
from repro_torch.examples import pid_hybrid
from repro_torch.kernels.lut_serve import (EngineRequirementError,
                                           compile_program, input_code_bounds)
from repro_torch.models import pid
from repro_torch.serve.api import EngineSpec, build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = 4
WF_LEN = 200
BATCH = 16
STEPS = 8                      # the example's smoke schedule
FLIP_FRAC = 2e-3
FLIP_ATOL = 2e-3
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-6
NOISE_REL = 0.05
PARAM_ATOL = 2e-5
NOISY_FRAC_PER_STEP = 0.03
ENTRY_FLIP_FRAC = 1e-4


def _ref_example():
    """The reference's ``examples/pid_hybrid.py`` as a module (its
    ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "ref_pid_hybrid_example", os.path.join(REPO, "examples", "pid_hybrid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_EX = _ref_example()


def _ref_params(seed):
    """Reference init (``init_pid_params``) with heterogeneous widths and
    non-zero biases, as numpy: the example's ``params`` dict."""
    layers = ref_pid.build_pid_layers(hidden=HIDDEN)
    params = ref_pid.init_pid_params(layers, jax.random.PRNGKey(seed))
    d = dict(zip(pid.PID_KEYS, jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(seed)
    for key, p in d.items():
        for q in [k for k in p if k.startswith("q_")]:
            for s in ("f", "i"):
                p[q][s] = p[q][s] + rng.uniform(-0.3, 0.3, p[q][s].shape)
        for b in ("b", "b_out"):
            if b in p:
                p[b] = rng.normal(0, 0.1, p[b].shape)
    return layers, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), d)


def _port_layers(d, seed=0):
    layers = pid.build_pid_layers(hidden=HIDDEN, device="cpu",
                                  generator=torch.Generator().manual_seed(seed))
    return interop.pid_params_from_numpy(layers, d)


def _data(n=BATCH, split="train"):
    return pid_hybrid.adc_data(0, n, WF_LEN, split)


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("seed,n,length,split", [
    (0, 24, 200, "train"), (0, 12, 3000, "test"), (3, 7, 600, "val"),
    (1, 5, 60, "train")])
def test_cepc_waveform_equal_arrays(seed, n, length, split):
    got = cepc_waveform(seed, n, length, split)
    want = ref_cepc_waveform(seed, n, length, split)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_cepc_waveform_default_length_is_the_papers():
    wf, counts, _ = cepc_waveform(0, 2)
    assert wf.shape == (2, 3000) and counts.shape == (2, 150)


# ------------------------------------------------------------ parameters
def test_layers_and_parameters_match_reference():
    ref_layers, d = _ref_params(0)
    layers = _port_layers(d)
    front, lc1, lc2, head = layers
    for mine, want in zip(layers, ref_layers):
        for k in ("c_in", "c_out", "kernel", "stride", "padding", "activation"):
            if hasattr(want, k):
                assert getattr(mine, k) == getattr(want, k), k
    assert (pid.WINDOW, pid.IN_F, pid.IN_I) == (ref_pid.WINDOW, ref_pid.IN_F, ref_pid.IN_I)
    back = interop.pid_params_to_numpy(layers)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(d)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(d)):
        np.testing.assert_array_equal(a, b)
    fresh = interop.pid_params_to_numpy(pid.build_pid_layers(
        hidden=HIDDEN, device="cpu", generator=torch.Generator().manual_seed(1)))
    init = dict(zip(pid.PID_KEYS, jax.tree_util.tree_map(
        np.asarray, ref_pid.init_pid_params(ref_layers, jax.random.PRNGKey(1)))))
    assert jax.tree_util.tree_structure(fresh) == jax.tree_util.tree_structure(init)
    paths = list(pid.pid_named_params(layers))
    assert paths[0] == "front/w" and "lc1/q_in/f" in paths and len(paths) == 30
    with pytest.raises(KeyError):
        interop.pid_params_from_numpy(layers, {"front": d["front"]})


def test_build_pid_graph_checks_the_window():
    layers = _port_layers(_ref_params(0)[1])
    g = pid.build_pid_graph(layers, 60)
    assert g.input.shape == (60, 1) and not g.input.signed
    assert isinstance(g.nodes[-1], port_lower.WindowSum)
    with pytest.raises(ValueError, match="not a multiple of the 20-sample"):
        pid.build_pid_graph(layers, 50)


# ------------------------------------------------------------ train steps
def _ref_cells(ref_layers, p, wf):
    """Per-cell SAT output codes of the LUT layers' train forward (JAX)."""
    front, lc1, lc2, head = ref_layers
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    h, _ = front.apply(pj["front"], jnp.asarray(wf)[..., None], train=True)
    out = []
    for layer, key in ((lc1, "lc1"), (lc2, "lc2"), (head, "head")):
        dense = getattr(layer, "dense", layer)
        x = (ref_ll.im2col_1d(h, layer.kernel, layer.stride, layer.padding)
             if hasattr(layer, "kernel") else h)
        xb = jnp.broadcast_to(x[..., :, None], x.shape + (dense.c_out,))
        y = dense.cell_mlp(pj[key], ref_fake_quant(pj[key]["q_in"], xb, dense.q_in))
        yq = ref_fake_quant(pj[key]["q_out"], y, dense.q_out)
        out.append(np.asarray(yq))
        h = jnp.sum(yq, axis=-2)
    return out


def _port_cells(layers, wf):
    front, *luts = layers
    out = []
    with torch.no_grad():
        front.train(True)
        h, _ = front(torch.as_tensor(wf)[..., None])
        for layer in luts:
            layer.train(True)
            x = layer._patches(h) if hasattr(layer, "_patches") else h
            yq, _ = getattr(layer, "dense", layer)._cells(x, True)
            out.append(yq.numpy())
            h = torch.sum(yq, dim=-2)
    return out


def _n_flips(ref_layers, p, layers, wf):
    want, got = _ref_cells(ref_layers, p, wf), _port_cells(layers, wf)
    n = sum(int((a != b).sum()) for a, b in zip(got, want))
    cells = sum(a.size for a in want)
    assert n <= FLIP_FRAC * cells, f"{n} of {cells} cells flipped"
    return n


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_step(ref_layers):
    acfg = ref_adam.AdamConfig(lr=pid_hybrid.LR)
    sched = ref_adam.cosine_restarts(pid_hybrid.LR, first_period=STEPS,
                                     warmup=min(20, STEPS // 2))

    @jax.jit
    def step(params, opt, wf, cnt):
        def loss_fn(p):
            pred, aux = REF_EX.forward(ref_layers, p, wf, True)
            mse = jnp.mean((pred - cnt) ** 2)
            return mse + REF_EX.BETA * aux.ebops, (aux, mse)
        (loss, (aux, mse)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params, opt, om = ref_adam.adam_update(params, g, opt, acfg, sched)
        return params, opt, {"loss": loss, "mse": mse, "ebops": aux.ebops, **om}, g

    return step


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_reference_example_step(n_steps):
    assert pid_hybrid.BETA == REF_EX.BETA
    ref_layers, d = _ref_params(5)
    layers = _port_layers(d)
    wf, cnt, _ = _data()
    ref_step = _ref_step(ref_layers)
    step_fn, init_fn = pid_hybrid.make_pid_train_step(layers, STEPS)
    rp = jax.tree_util.tree_map(jnp.asarray, d)
    ro = ref_adam.adam_init(rp)
    po = init_fn()
    noisy, total_flips = {}, 0
    for s in range(n_steps):
        rnp = jax.tree_util.tree_map(np.asarray, rp)
        n_flips = _n_flips(ref_layers, rnp, layers, wf)
        total_flips += n_flips
        loss, mse, ebops, pg = pid_hybrid.pid_loss_and_grads(
            layers, torch.as_tensor(wf), torch.as_tensor(cnt))
        rp, ro, rm, rg = ref_step(rp, ro, jnp.asarray(wf), jnp.asarray(cnt))
        rg = _flat(rg)
        assert sorted(pg) == sorted(rg)
        for path, g in pg.items():
            w = rg[path]
            d_ = np.abs(g.numpy() - w)
            floor = GRAD_RTOL * float(np.abs(w).max())
            tol = floor + GRAD_ATOL + FLIP_ATOL * n_flips
            assert float(d_.max()) <= tol, f"step {s + 1} grad {path}: {d_.max()} > {tol}"
            bad = (d_ > 0) & ((np.abs(w) <= floor) | (d_ > NOISE_REL * np.abs(w)))
            noisy[path] = noisy.get(path, False) | bad
        po, pm = step_fn(po, torch.as_tensor(wf), torch.as_tensor(cnt))
        for k in ("loss", "mse"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5, abs=1e-6)
        assert float(pm["ebops"]) == pytest.approx(float(rm["ebops"]), rel=1e-6)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-3 if n_flips else 1e-4)
        assert float(pm["mse"]) == pytest.approx(float(mse), rel=1e-6)
    # the state after n_steps
    assert int(po["step"]) == int(ro["step"]) == n_steps
    got = {k: v.detach().numpy() for k, v in pid.pid_named_params(layers).items()}
    want, wm, wv = _flat(rp), _flat(ro["m"]), _flat(ro["v"])
    lr_bound = 2 * pid_hybrid.LR * n_steps
    n_noisy = n_total = 0
    for path, mask in noisy.items():
        n_noisy += int(mask.sum())
        n_total += mask.size
        for name, a, b, quiet, loud in (
                ("param", got[path], want[path], PARAM_ATOL, lr_bound),
                ("m", po["m"][path].numpy(), wm[path], 1e-4, 1.0),
                ("v", po["v"][path].numpy(), wv[path], 1e-5, 1.0)):
            tol = np.where(mask, loud, quiet + FLIP_ATOL * total_flips + 1e-3 * np.abs(b))
            d_ = np.abs(a - b)
            assert (d_ <= tol).all(), f"{name} {path}: max|d| {d_.max()}"
    print(f"noisy elements after {n_steps} step(s): {n_noisy} of {n_total}; "
          f"{total_flips} cell flips")
    assert n_noisy <= NOISY_FRAC_PER_STEP * n_steps * n_total


def test_fused_pid_step_matches_einsum_step():
    """The LUT layers on the fused pair (B2/B3's plain versions here) give
    the einsum path's loss and gradients: the route chip_smoke holds B2 and
    B3 to on the card."""
    _ref_layers, d = _ref_params(6)
    wf, cnt, _ = _data()
    outs = []
    for fused in (None, True):
        layers = _port_layers(d)
        outs.append(pid_hybrid.pid_loss_and_grads(
            layers, torch.as_tensor(wf), torch.as_tensor(cnt), fused=fused))
    (l0, m0, e0, g0), (l1, m1, e1, g1) = outs
    assert float(m1) == pytest.approx(float(m0), rel=1e-5)
    assert float(e1) == float(e0)
    for path in g0:
        w = g0[path].numpy()
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert float(np.abs(g1[path].numpy() - w).max()) <= tol, path


# ---------------------------------------------------------------- lowering
@pytest.fixture(scope="module", params=[40, 60], ids=["ctx40", "ctx60"])
def lowered(request):
    """Both packages' lowerings of the same hybrid parameters at one context,
    and the port's layers."""
    ctx = request.param
    ref_layers, d = _ref_params(2)
    params = [jax.tree_util.tree_map(jnp.asarray, d[k]) for k in pid.PID_KEYS]
    want = ref_lower(ref_pid.build_pid_graph(ref_layers, n_samples=ctx),
                     [*params, None])
    layers = _port_layers(d)
    return ctx, want, layers


def test_lowering_identical_with_reference_tables(lowered, monkeypatch):
    ctx, want, layers = lowered
    tables = iter(want.tables[k] for k in sorted(want.tables))
    monkeypatch.setattr(port_lower, "extract_tables", lambda layer: LayerTables(
        **{f: getattr(t, f) for t in [next(tables)]
           for f in LayerTables.__dataclass_fields__}))
    got = port_lower.lower(pid.build_pid_graph(layers, n_samples=ctx))
    a, b = got.to_arrays(), want.to_arrays()
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    kinds = [s.kind for s in got.segments]
    assert kinds.count("hgq") == ctx // pid.WINDOW and kinds.count("acc") == 1


def test_extract_tables_matches_reference(lowered):
    _ctx, want, layers = lowered
    n_flip = n_entries = 0
    for lid, layer in zip((1, 2, 3), layers[1:]):
        t = want.tables[lid]
        got = extract_tables(layer)
        for fld in ("f_in", "i_in", "f_out", "i_out", "in_width", "out_width"):
            np.testing.assert_array_equal(getattr(got, fld), getattr(t, fld))
        d = got.codes - t.codes
        assert np.all(np.abs(d) <= 1)
        n_flip += int(np.count_nonzero(d))
        n_entries += d.size
    assert n_flip <= ENTRY_FLIP_FRAC * n_entries, n_flip


@pytest.mark.parametrize("engine", ["pallas", "fused"])
def test_port_engine_bit_exact_vs_reference_interpreter(lowered, engine):
    """The port's own lowering (its own tables) served by its engine equals
    the reference's ``DaisProgram.run`` of the same program, bit for bit."""
    ctx, _want, layers = lowered
    prog = port_lower.lower(pid.build_pid_graph(layers, n_samples=ctx))
    ref = RefDaisProgram.from_arrays(prog.to_arrays())
    eng = compile_program(prog, device="cpu", engine=engine)
    assert eng.path == engine and eng.dtype == torch.int32
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(ctx).integers(lo, hi + 1, (512, len(lo)))
    wf, _, _ = _data(64, "test")
    from repro_torch.core.quant import quantize_to_int
    real = quantize_to_int(wf[:, :ctx], pid.IN_F, pid.IN_I, False, "SAT")
    for c in (codes, real):
        np.testing.assert_array_equal(eng.run(c).numpy().astype(np.int64), ref.run(c))
    np.testing.assert_array_equal(prog.run(codes), ref.run(codes))


def test_eval_forward_against_the_program_c12(lowered):
    """The eval forward's window-count sums against ``run_float`` of the
    lowering.  With the front's bias on the program's grid
    (``deploy_counts``) they are equal bit for bit.  With its float bias
    they differ where a front output lands on a rounding tie of lc1's input
    grid (ROADMAP C12): the port's gap is the reference's, waveform for
    waveform, given the same parameters."""
    ctx, want_prog, layers = lowered
    prog = port_lower.lower(pid.build_pid_graph(layers, n_samples=ctx))
    wf, _, _ = _data(128, "test")
    x = wf[:, :ctx]
    want = prog.run_float(x)[:, 0]
    np.testing.assert_array_equal(
        pid_hybrid.deploy_counts(layers, x, "cpu").sum(axis=1), want)
    gap = pid_hybrid.eval_counts(layers, x, "cpu").sum(axis=1) - want
    ref_layers = ref_pid.build_pid_layers(hidden=HIDDEN)
    d = interop.pid_params_to_numpy(layers)
    params = {k: jax.tree_util.tree_map(jnp.asarray, d[k]) for k in pid.PID_KEYS}
    ref_pred, _ = REF_EX.forward(ref_layers, params, jnp.asarray(x), False)
    ref_gap = np.asarray(ref_pred, np.float64).sum(axis=1) - want_prog.run_float(x)[:, 0]
    np.testing.assert_array_equal(gap, ref_gap)
    held = pid_hybrid.bias_gap(layers, x, want, "cpu")
    assert held["dq"] == np.abs(gap).max() and held["n_dq"] == np.count_nonzero(gap)
    assert held["n_dq"] <= held["n_tie"]


def test_one_window_context_raises_c4():
    """ROADMAP C4, repaired: at one window the program does not compose into
    fused stages; the port degrades to its generic runner, as the reference
    does, with the warning, and serves it bit-exactly; only ``require=
    "fused"`` still raises."""
    from repro.kernels.lut_serve import compile_program as ref_compile

    layers = _port_layers(_ref_params(0)[1])
    prog = port_lower.lower(pid.build_pid_graph(layers, n_samples=20))
    with pytest.raises(EngineRequirementError, match="ADD nested inside a unary chain"):
        build(prog, EngineSpec(engine="pallas", require="fused"), device="cpu")
    with pytest.warns(UserWarning, match="downgraded to 'generic'"):
        built = build(prog, EngineSpec(engine="pallas", n_random=512), device="cpu")
    eng = built.engine
    assert eng.path == "generic" and "ADD nested inside a unary chain" in eng.fuse_reason
    ref = RefDaisProgram.from_arrays(prog.to_arrays())
    with pytest.warns(UserWarning, match="downgraded to 'generic'"):
        ref_eng = ref_compile(ref, engine="pallas")
    assert ref_eng.path == "generic" and ref_eng.fuse_reason == eng.fuse_reason
    assert ref_eng.n_groups == eng.n_groups
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(4).integers(lo, hi + 1, (256, len(lo)))
    got = eng.run(codes).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, ref.run(codes))
    np.testing.assert_array_equal(got, np.asarray(ref_eng.run(codes), np.int64))


# ------------------------------------------------------ example, launcher
def test_example_smoke_runs_to_the_gate(capsys, tmp_path):
    verilog = tmp_path / "pid.v"
    out = pid_hybrid.main(["--device", "cpu", "--smoke", "--steps", "3",
                           "--verilog", str(verilog)])
    assert out["steps"] == 3 and out["path"] == "pallas" and out["served"] == 48
    assert out["rtl"]["verdict"] == "bit-exact" and out["rtl"]["engine_path"] == "pallas"
    assert verilog.read_text().startswith("module pid_hybrid")
    assert np.isfinite(out["gap"]["dq"]) and np.isfinite(out["sep"])
    assert out["gap"]["n_dq"] <= out["gap"]["n_tie"]
    text = capsys.readouterr().out
    assert "bit-exact gate PASSED" in text and "served 48 test waveforms" in text
    assert "equal with the front's bias on the program's grid" in text


@pytest.mark.parametrize("ctx", [40, 30, 20])
def test_launcher_pid_hybrid(capsys, ctx):
    from repro_torch.launch.serve import main

    argv = ["--device", "cpu", "--engine", "pallas", "--model", "pid-hybrid",
            "--ctx", str(ctx), "--lut-hidden", "4", "--batch", "64", "--gen", "2"]
    if ctx != 30:
        main(argv)
        out = capsys.readouterr().out
        path = "pallas" if ctx == 40 else "generic"      # ctx 20: C4, repaired
        assert f"model=pid-hybrid ctx={ctx}" in out and f"path={path}" in out
        assert "bit-exact gate PASSED: 2048 random" in out
        assert ("[serve] path downgraded to 'generic': pallas (and fused) "
                "unavailable: ADD nested inside a unary chain" in out) == (ctx == 20)
        return
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert "context length 30 is not a multiple of the 20-sample DAQ window" in str(e.value)
