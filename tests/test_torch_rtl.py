"""Port parity for the hardware side of the IR tooling: Verilog emission
(``core/rtl.py``), the RTL simulator (``core/rtl_sim.py``), the three-way
attestation, the lint report (``launch/lint.py``) and the serve launcher's
``--dce --lint --verify-rtl``, on the CPU.

* ``emit_verilog`` is held to the reference's text by sha256, on the
  JSC-HLF stack and the pid hybrid at contexts of 20 and 40 samples;
* the port's ``RtlModule`` is held bit for bit to the reference's simulator
  and to ``DaisProgram.run`` on the same codes: the IEEE-rule modules of the
  reference's ``tests/test_rtl_sim.py`` over every 8-bit input, and its
  program builders over deterministic sweeps (small sizes, no deadline);
* ``verify_rtl`` runs three ways with the port's engines on the CPU and
  fails, never falls back, when the engine disagrees;
* the lint text equals the reference's, its timings masked.
"""

import hashlib
import re

import jax
import numpy as np
import pytest
import torch

from repro.core import rtl as ref_rtl
from repro.core import rtl_sim as ref_rtl_sim
from repro.core.dais import DaisProgram as RefDaisProgram
from repro_torch.core.dais import DaisProgram
from repro_torch.core.rtl import emit_verilog, verify_rtl
from repro_torch.core.rtl_sim import RtlModule, RtlSimError
from repro_torch.kernels.lut_serve import compile_program, input_code_bounds
from test_rtl_sim import (_addsub_prog, _cmul_prog, _dense_stack,
                          _hybrid_conv_prog, _llut_prog, _requant_prog)

torch.set_num_threads(2)

IN_F, IN_I = 4, 2


def _port(ref: RefDaisProgram) -> DaisProgram:
    return DaisProgram.from_arrays(ref.to_arrays())


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def _codes(prog, n, seed):
    lo, hi = input_code_bounds(prog)
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, len(lo)))


@pytest.fixture(scope="module")
def jsc():
    from repro_torch.core.lower import compile_sequential
    from repro_torch.launch.serve import build_lut_stack

    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    for layer in layers:
        layer.eval()
    return compile_sequential(layers, IN_F, IN_I)


def _pid(ctx):
    from repro_torch.core.lower import lower
    from repro_torch.models.pid import build_pid_graph, build_pid_layers

    layers = build_pid_layers(hidden=4, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    for layer in layers:
        layer.eval()
    return lower(build_pid_graph(layers, n_samples=ctx))


# --------------------------------------------------------------------------- #
# Verilog text: the reference's, byte for byte
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["jsc", "pid20", "pid40"])
def test_emit_verilog_sha256_equals_the_reference(jsc, which):
    prog = jsc if which == "jsc" else _pid(int(which[3:]))
    ref = RefDaisProgram.from_arrays(prog.to_arrays())
    for name in ("hgq_lut_model", "dut"):
        got = emit_verilog(prog, name=name)
        want = ref_rtl.emit_verilog(ref, name=name)
        assert _sha(got) == _sha(want)
    assert "module dut" in got and got.endswith("endmodule\n")


@pytest.mark.parametrize("which", ["dense", "hybrid_conv", "dce"])
def test_emit_verilog_equals_the_reference_on_its_fixtures(which):
    from repro.core.opt import eliminate_dead_cells

    ref = {"dense": lambda: _dense_stack([4, 5, 3], 0),
           "hybrid_conv": _hybrid_conv_prog,
           "dce": lambda: eliminate_dead_cells(_dense_stack([4, 6, 2], 5))[0]}[which]()
    assert emit_verilog(_port(ref), name="dut") == ref_rtl.emit_verilog(ref, name="dut")


# --------------------------------------------------------------------------- #
# the simulator: the reference's, on its IEEE-rule modules
# --------------------------------------------------------------------------- #
PORTS8 = "    input  wire signed [7:0] in_0,\n    output wire signed [7:0] out_0"
MODULES = {
    "unsized_literal": "  wire signed [39:0] r0 = 8589934592;\n  assign out_0 = r0[7:0];",
    "sized_literal_hi": "  wire signed [39:0] r0 = 40'sd8589934592;\n"
                        "  assign out_0 = r0[33:26];",
    "self_determined": "  wire [3:0] a = in_0[3:0];\n  wire [3:0] y = (a + a) >> 1;\n"
                       "  assign out_0 = y;",
    "wrap_on_assign": "  wire signed [3:0] y = in_0;\n  assign out_0 = y;",
    "arith_shift": "  wire signed [7:0] a = in_0;\n  wire signed [7:0] s = a >>> 2;\n"
                   "  wire [7:0] u = $unsigned(a) >>> 2;\n  assign out_0 = s - u;",
    "zero_extension": "  wire [7:0] u = in_0;\n"
                      "  wire signed [9:0] y = $signed({1'b0, u}) - 10'sd1;\n"
                      "  assign out_0 = y[7:0];",
    "mixed_sign": "  wire signed [3:0] a = in_0[3:0];\n  wire [7:0] u = in_0;\n"
                  "  wire [7:0] y = a + u;\n  assign out_0 = y;",
    "signed_context": "  wire signed [3:0] a = in_0[3:0];\n"
                      "  wire signed [7:0] z = a + 8'sd0;\n  assign out_0 = z;",
    "ternary_compare": "  wire signed [7:0] a = in_0;\n"
                       "  wire signed [7:0] y = (a > 8'sd3) ? a - 8'sd3 : -a;\n"
                       "  assign out_0 = y ^ 8'sd5;",
}


def _mod(mod, body):
    return mod.RtlModule.parse(f"module t (\n{PORTS8}\n);\n{body}\nendmodule\n")


@pytest.mark.parametrize("name", sorted(MODULES))
def test_simulator_equals_the_reference_on_every_8_bit_input(name):
    codes = np.arange(-128, 128, dtype=np.int64)[:, None]
    got = RtlModule.parse(f"module t (\n{PORTS8}\n);\n{MODULES[name]}\nendmodule\n").run(codes)
    want = _mod(ref_rtl_sim, MODULES[name]).run(codes)
    np.testing.assert_array_equal(got, want)


def test_simulator_rejects_what_the_reference_rejects():
    bad_select = "  wire signed [3:0] y = in_0[9:2];\n  assign out_0 = y;"
    with pytest.raises(RtlSimError, match="exceeds declared width"):
        RtlModule.parse(f"module t (\n{PORTS8}\n);\n{bad_select}\nendmodule\n").run(
            np.asarray([[1]]))
    with pytest.raises(ref_rtl_sim.RtlSimError, match="exceeds declared width"):
        _mod(ref_rtl_sim, bad_select).run(np.asarray([[1]]))
    dup = "  wire signed [3:0] y = in_0;\n  wire signed [3:0] y = in_0;\n  assign out_0 = y;"
    with pytest.raises(RtlSimError, match="duplicate"):
        RtlModule.parse(f"module t (\n{PORTS8}\n);\n{dup}\nendmodule\n")
    with pytest.raises(RtlSimError):
        RtlModule.parse("module t (\n    input  wire [1:0] in_0,\n"
                        "    output wire [1:0] out_0\n);\n"
                        "  always @(posedge clk) q <= in_0;\nendmodule\n")


def _builders():
    rng = np.random.default_rng(0)
    out = []
    for k in range(10):
        src_f, src_i, f, i = (int(a) for a in rng.integers(0, 4, 4))
        out.append((f"requant{k}", _requant_prog(src_f, src_i, bool(k % 2), f, i,
                                                 bool(k % 3), ("SAT", "WRAP")[k % 2])))
    for k in range(6):
        fa, fb = (int(a) for a in rng.integers(0, 4, 2))
        wa, wb = (int(a) for a in rng.integers(2, 8, 2))
        out.append((f"addsub{k}", _addsub_prog(("ADD", "SUB")[k % 2], fa, wa, fb, wb)))
    for k, code in enumerate([3, -5, 1 << 33, -(1 << 34) + 7, 0]):
        out.append((f"cmul{k}", _cmul_prog(code, 1, 4 + k)))
    for k in range(4):
        m, n, src_w = int(rng.integers(1, 5)), int(rng.integers(1, 6)), int(rng.integers(1, 8))
        codes = rng.integers(-(1 << (n - 1)), 1 << (n - 1), 1 << m)
        out.append((f"llut{k}", _llut_prog(m, n, codes, src_w)))
    out.append(("dense", _dense_stack([3, 4, 2], 1)))
    out.append(("hybrid_conv", _hybrid_conv_prog()))
    return out


@pytest.mark.parametrize("k", range(len(_builders())))
def test_simulator_equals_the_reference_and_the_interpreter(k):
    name, ref = _builders()[k]
    prog = _port(ref)
    src = emit_verilog(prog, name="dut")
    assert src == ref_rtl.emit_verilog(ref, name="dut"), name
    lo, hi = input_code_bounds(prog)
    if np.prod((hi - lo + 1).astype(np.float64)) <= 4096:
        grid = np.indices(tuple(int(s) for s in hi - lo + 1))
        codes = grid.reshape(len(lo), -1).T + lo[None, :]
    else:
        codes = _codes(prog, 256, seed=k)
    sim = RtlModule.parse(src)
    got = sim.run(codes)
    assert sim.n_wires == ref_rtl_sim.RtlModule.parse(src).n_wires
    np.testing.assert_array_equal(got, ref_rtl_sim.RtlModule.parse(src).run(codes))
    np.testing.assert_array_equal(got, ref.run(codes))
    np.testing.assert_array_equal(got, prog.run(codes))


# --------------------------------------------------------------------------- #
# the three-way attestation with the port's engines
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["pallas", "fused", "groups"])
def test_verify_rtl_three_way_on_the_cpu(jsc, engine):
    eng = compile_program(jsc, device="cpu", engine=engine)
    att = verify_rtl(jsc, engine=eng, n_random=64, seed=0)
    want = ref_rtl.verify_rtl(RefDaisProgram.from_arrays(jsc.to_arrays()),
                              n_random=64, seed=0)
    assert att["verdict"] == "bit-exact" and att["engine_path"] == eng.path
    for key in ("random", "exhaustive", "n_wires", "verilog_sha256"):
        assert att[key] == want[key]


def test_verify_rtl_three_way_one_window_pid_and_dce():
    from repro_torch.core.opt import eliminate_dead_cells, verify_optimized_rtl

    prog = _pid(20)
    with pytest.warns(UserWarning, match="downgraded to 'generic'"):
        eng = compile_program(prog, device="cpu", engine="pallas")
    assert eng.path == "generic"
    assert verify_rtl(prog, engine=eng, n_random=64)["engine_path"] == "generic"
    opt, rep = eliminate_dead_cells(prog)
    assert rep.n_llut_after < rep.n_llut_before
    with pytest.warns(UserWarning):
        eng = compile_program(opt, device="cpu", engine="pallas")
    att = verify_rtl(opt, oracle=prog, engine=eng, n_random=64, seed=1)
    assert att["verdict"] == "bit-exact"
    assert verify_optimized_rtl(prog, opt, n_random=64)["verdict"] == "bit-exact"


def test_verify_rtl_fails_on_a_wrong_engine_or_module():
    prog = _port(_requant_prog(2, 2, True, 2, 2, True, "WRAP"))
    eng = compile_program(prog, device="cpu", engine="groups")

    class OffByOne:
        path = "generic"

        def run(self, codes):
            return eng.run(codes) + 1

    with pytest.raises(AssertionError, match="serving engine != DAIS interpreter"):
        verify_rtl(prog, engine=OffByOne(), n_random=16)
    v = emit_verilog(prog, name="t").replace("r0;", "(r0 + 6'sd1);", 1)
    with pytest.raises(AssertionError, match="RTL simulation"):
        verify_rtl(prog, v, n_random=16, seed=0)


# --------------------------------------------------------------------------- #
# lint: the reference's report
# --------------------------------------------------------------------------- #
_TIMING = re.compile(r"\d+\.\d+s\)")


def _lint_lines(lint_program, prog, **kw):
    lines = []
    rep = lint_program(prog, echo=lines.append, **kw)
    return rep, [_TIMING.sub("Ts)", line) for line in lines]


@pytest.mark.parametrize("which", ["jsc", "pid20", "bad"])
@pytest.mark.parametrize("all_regs", [False, True])
def test_lint_text_equals_the_reference(jsc, which, all_regs):
    from repro.launch.lint import lint_program as ref_lint
    from repro_torch.launch.lint import lint_program

    if which == "bad":
        prog = _port(_requant_prog(2, 2, True, 2, 2, True, "WRAP"))
        prog.output_f = [3]
    else:
        prog = jsc if which == "jsc" else _pid(20)
    ref = RefDaisProgram.from_arrays(prog.to_arrays())
    rep, got = _lint_lines(lint_program, prog, name=which, all_regs=all_regs)
    want_rep, want = _lint_lines(ref_lint, ref, name=which, all_regs=all_regs)
    assert got == want
    assert rep == want_rep
    assert rep["ok"] == (which != "bad")


def test_lint_cli(capsys):
    from repro_torch.launch.lint import main

    main(["--device", "cpu", "--model", "lut-stack", "--lut-dims", "6,4,2",
          "--lut-hidden", "4"])
    out = capsys.readouterr().out
    assert "verifier: ok" in out and "proven_width" in out
    assert "dce round self-certified" in out
    main(["--device", "cpu", "--model", "pid-hybrid", "--ctx", "20",
          "--lut-hidden", "4", "--no-dce"])
    out = capsys.readouterr().out
    assert "model=pid-hybrid ctx=20" in out and "dce round" not in out
    with pytest.raises(SystemExit) as e:
        main(["model.npz"])
    assert e.value.code == 2
    assert "ROADMAP A4" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main([])


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["lut-stack", "pid-hybrid"])
def test_launcher_dce_lint_verify_rtl(capsys, model):
    from repro_torch.launch.serve import main

    argv = ["--device", "cpu", "--engine", "pallas", "--model", model,
            "--lut-dims", "8,6,3", "--lut-hidden", "4", "--ctx", "20",
            "--batch", "64", "--gen", "2", "--dce", "--lint", "--verify-rtl"]
    main(argv)
    out = capsys.readouterr().out
    path = "generic" if model == "pid-hybrid" else "pallas"
    assert "[lint]   verifier: ok" in out and "[serve] dce: instrs" in out
    assert f"path={path}" in out and "bit-exact gate PASSED: 2048 random" in out
    assert (f"rtl gate PASSED: bit-exact three ways (RTL sim == DAIS interpreter "
            f"== {path} engine) over 2048 random") in out
    assert "2 batches x 64 rows" in out
