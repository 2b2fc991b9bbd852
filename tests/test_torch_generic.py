"""Port parity for the generic op-group runner (``engine="groups"``), the
engine's path downgrades, ``narrow=`` and ``lower_tables``, on the CPU.

The programs are the ones of the reference's ``tests/test_lut_serve.py``:
built and lowered by the JAX package, carried into the port as numpy
(``to_arrays`` / ``from_arrays``).  Every integer result is exact: the
port's generic engine is held bit for bit against the port's and the
reference's ``DaisProgram.run``, against the reference's own generic engine
(``compile_program(prog, fuse_layers=False)``) and, where the program
composes, against the port's fused and packed-chain engines.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro.core.dais import Reg as RefReg
from repro.core.dais import Segment as RefSegment
from repro.core.dais import compile_sequential as ref_compile_sequential
from repro.core.hgq_layers import HGQConv1D, HGQDense
from repro.core.lower import (Flatten, GraphInput, ModelGraph, ReLU,
                              WindowSum, lower)
from repro.core.lut_layers import LUTConv1D, LUTDense
from repro.core.quant import QuantConfig, quantize_to_int
from repro.core.tables import extract_tables
from repro.kernels import lut_serve as ref_serve
from repro_torch.core.dais import DaisProgram
from repro_torch.core.tables import LayerTables
from repro_torch.kernels.lut_serve import (EnginePathWarning,
                                           EngineRequirementError,
                                           _requant_cols, _shift_round,
                                           compile_program, input_code_bounds,
                                           lower_tables, verify_engine)
from repro_torch.serve.api import EngineSpec, build

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(11)
IN_F, IN_I = 4, 2


def _narrow_cfg(overflow):
    return QuantConfig(granularity="element", signed=True, overflow=overflow,
                       init_f=1.0, init_i=1.0, min_f=-2, max_f=2,
                       min_i=-2, max_i=2)


def _exhaustive():
    layer = LUTDense(3, 4, hidden=4,
                     q_in=_narrow_cfg("WRAP"), q_out=_narrow_cfg("SAT"))
    return ref_compile_sequential([layer], [layer.init(jax.random.PRNGKey(7))], 1, 1)


def _two_layer():
    l1 = LUTDense(6, 9, hidden=4, use_batchnorm=True)
    l2 = LUTDense(9, 3, hidden=4)
    k1, k2 = jax.random.split(KEY)
    return ref_compile_sequential([l1, l2], [l1.init(k1), l2.init(k2)], IN_F, IN_I)


def _hybrid_dense():
    h1 = HGQDense(6, 5, activation="relu")
    l1 = LUTDense(5, 4, hidden=4)
    k1, k2 = jax.random.split(KEY)
    return ref_compile_sequential([h1, l1], [h1.init(k1), l1.init(k2)], IN_F, IN_I)


def _hybrid_conv():
    front = HGQConv1D(c_in=1, c_out=3, kernel=4, stride=4, activation="relu")
    lc = LUTConv1D(c_in=3, c_out=3, kernel=3, padding="SAME", hidden=4)
    head = LUTDense(3, 1, hidden=4)
    ks = jax.random.split(KEY, 3)
    params = [front.init(ks[0]), lc.init(ks[1]), head.init(ks[2])]
    graph = ModelGraph(GraphInput((16, 1), IN_F, IN_I), [front, lc, head, WindowSum()])
    return lower(graph, params + [None])


def _relu_wide():
    h1 = HGQDense(6, 3)
    graph = ModelGraph(GraphInput((6,), IN_F, IN_I), [h1, ReLU()])
    return lower(graph, [h1.init(jax.random.PRNGKey(2)), None])


def _relu_flatten():
    conv = LUTConv1D(c_in=2, c_out=3, kernel=2, hidden=4)
    tail = LUTDense(9, 2, hidden=4)
    k1, k2 = jax.random.split(KEY)
    graph = ModelGraph(GraphInput((4, 2), IN_F, IN_I), [conv, ReLU(), Flatten(), tail])
    return lower(graph, [conv.init(k1), None, None, tail.init(k2)])


def _mixed_epilogue():
    prog = RefDaisProgram()
    prog.input_f = [0, 0]
    prog.input_signed = [True, False]
    r0 = prog.emit("IN", (0,), RefReg(0, 8, True))
    r1 = prog.emit("IN", (1,), RefReg(0, 8, False))
    a1 = prog.emit("CMUL", (r0, 3, 0), RefReg(0, 11, True))
    a2 = prog.emit("CMUL", (r1, 5, 0), RefReg(0, 12, True))
    s = prog.emit("ADD", (a1, a2), RefReg(0, 13, True))
    out_a = prog.emit("REQUANT", (s, 0, 13, False, "SAT", 0), RefReg(0, 13, False))
    # unsigned values past 2**29: a shift to the top of the int32 engine's range
    out_b = prog.emit("CMUL", (r1, 1 << 22, 0), RefReg(0, 30, False))
    prog.outputs = [out_a, out_b]
    prog.output_f = [0, 0]
    prog.segments.append(RefSegment(kind="hgq", layer_id=0, in_regs=(r0, r1),
                                    out_regs=(out_a, out_b)))
    return prog


def _wide_operand():
    h1 = HGQDense(3, 2)
    return ref_compile_sequential([h1], [h1.init(KEY)], input_f=18, input_i=6)


PROGRAMS = {"exhaustive": _exhaustive, "two_layer": _two_layer,
            "hybrid_dense": _hybrid_dense, "hybrid_conv": _hybrid_conv,
            "relu_wide": _relu_wide, "relu_flatten": _relu_flatten,
            "mixed_epilogue": _mixed_epilogue, "wide_operand": _wide_operand}
# what the reference's fused composer does with each
COMPOSES = {"exhaustive": True, "two_layer": True, "hybrid_dense": True,
            "hybrid_conv": True, "relu_wide": True, "relu_flatten": True,
            "mixed_epilogue": True, "wide_operand": False}


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def case(request):
    ref = PROGRAMS[request.param]()
    return request.param, ref, DaisProgram.from_arrays(ref.to_arrays())


def _codes(prog, n, seed):
    lo, hi = input_code_bounds(prog)
    sizes = hi - lo + 1
    if np.prod(sizes.astype(np.float64)) <= 4096:      # every input code
        grid = np.indices(tuple(int(s) for s in sizes))
        return grid.reshape(len(lo), -1).T + lo[None, :]
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, len(lo)))


def _host(out) -> np.ndarray:
    return out.cpu().numpy().astype(np.int64)


def test_generic_matches_both_interpreters_and_the_reference_engine(case):
    name, ref, prog = case
    eng = compile_program(prog, device="cpu", engine="groups")
    assert eng.path == "generic" and eng.fuse_reason == ""
    ref_eng = ref_serve.compile_program(ref, fuse_layers=False)
    assert ref_eng.path == "generic"
    assert eng.n_groups == ref_eng.n_groups == len(ref.schedule())
    assert str(eng.dtype).replace("torch.", "") == np.dtype(ref_eng.dtype).name
    codes = _codes(prog, 1024, seed=3)
    want = ref.run(codes)
    np.testing.assert_array_equal(prog.run(codes), want)
    got = eng.run(codes)
    assert got.dtype == eng.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_host(got), want)
    np.testing.assert_array_equal(
        np.asarray(jax.device_get(ref_eng.run(codes)), np.int64), want)
    stats = verify_engine(eng, prog, n_random=256)
    assert stats["n_groups"] == eng.n_groups
    if name == "exhaustive":
        assert stats["exhaustive"] == 512
        np.testing.assert_array_equal(ref.tables[0].lookup_codes(codes, 1), want)


def test_generic_equals_fused_and_packed_where_the_program_composes(case):
    name, ref, prog = case
    codes = _codes(prog, 1024, seed=4)
    generic = _host(compile_program(prog, device="cpu", engine="groups").run(codes))
    for engine in ("fused", "pallas"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = compile_program(prog, device="cpu", engine=engine)
        ref_eng = ref_serve.compile_program(ref, engine=engine)
        assert (eng.path == "generic") == (ref_eng.path == "generic") == (not COMPOSES[name])
        if not COMPOSES[name]:
            assert eng.fuse_reason == ref_eng.fuse_reason
            assert [str(w.message) for w in caught
                    if issubclass(w.category, EnginePathWarning)] == [
                f"engine path downgraded to 'generic': {eng.fuse_reason}"]
        np.testing.assert_array_equal(_host(eng.run(codes)), generic)


def test_flat_program_degrades_with_a_warning():
    ref = _two_layer()
    flat = DaisProgram.from_arrays(ref.to_arrays())
    flat.segments = []
    for engine, why in (("fused", "fused unavailable"),
                        ("pallas", "pallas (and fused) unavailable")):
        with pytest.warns(EnginePathWarning, match="downgraded to 'generic'"):
            eng = compile_program(flat, device="cpu", engine=engine)
        assert eng.path == "generic"
        assert eng.fuse_reason == f"{why}: program has no segment metadata"
        assert eng.n_launches == eng.n_groups == len(flat.schedule())
        verify_engine(eng, flat, n_random=256)
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # no warning for what was asked
        assert compile_program(flat, device="cpu", engine="groups").path == "generic"
    with pytest.raises(ValueError, match="unknown engine"):
        compile_program(flat, device="cpu", engine="tables")


def test_require_fused_raises_in_build_not_in_compile():
    prog = DaisProgram.from_arrays(_wide_operand().to_arrays())
    with pytest.warns(EnginePathWarning):
        built = build(prog, EngineSpec(engine="pallas", n_random=128), device="cpu")
    assert built.engine.path == "generic" and built.attestation["random"] == 128
    assert built.oracle is built.prog is prog
    for require in ("fused", "pallas"):
        with pytest.warns(EnginePathWarning), \
                pytest.raises(EngineRequirementError,
                              match=f"require='{require}'.*generic"):
            build(prog, EngineSpec(engine="pallas", require=require), device="cpu")
    built = build(prog, EngineSpec(engine="groups"), device="cpu")
    assert built.engine.path == "generic" and built.engine.fuse_reason == ""


@pytest.mark.parametrize("narrow", [True, False])
def test_narrow_flag_dtypes_and_outputs(case, narrow):
    name, ref, prog = case
    codes = _codes(prog, 512, seed=5)
    want = ref.run(codes)
    for engine in ("pallas", "groups"):
        eng = compile_program(prog, device="cpu", engine=engine, narrow=narrow)
        ref_eng = ref_serve.compile_program(ref, engine=engine, narrow=narrow)
        assert eng.path == ref_eng.path
        assert str(eng.dtype).replace("torch.", "") == np.dtype(ref_eng.dtype).name
        if eng.path == "pallas":
            assert eng.packed_table_bytes == ref_eng.packed_table_bytes
        np.testing.assert_array_equal(_host(eng.run(codes)), want)


def test_narrow_false_keeps_full_rows_in_the_chain():
    ref = _hybrid_conv()
    prog = DaisProgram.from_arrays(ref.to_arrays())
    narrow = compile_program(prog, device="cpu", engine="pallas")
    wide = compile_program(prog, device="cpu", engine="pallas", narrow=False)
    assert narrow.path == wide.path == "pallas"
    assert wide.packed_table_bytes >= narrow.packed_table_bytes
    assert wide.dtype == torch.int32 and prog.required_width() <= 30
    codes = _codes(prog, 1024, seed=6)
    np.testing.assert_array_equal(_host(wide.run(codes)), _host(narrow.run(codes)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_tables_matches_lookup_codes_and_the_reference(seed):
    k = jax.random.PRNGKey(seed)
    layer = LUTDense(6, 9, hidden=4, use_batchnorm=(seed % 2 == 0))
    ref_t = extract_tables(layer, layer.init(k))
    t = LayerTables(**{f: np.asarray(getattr(ref_t, f)) for f in
                       ("f_in", "i_in", "f_out", "i_out", "in_width", "out_width",
                        "codes")})
    x = np.asarray(jax.random.normal(k, (256, 6))) * 2
    codes = quantize_to_int(x, IN_F, IN_I, True, "SAT")
    fn = lower_tables(t, IN_F, x_width=IN_F + IN_I + 1, device="cpu")
    got = _host(fn(codes))
    np.testing.assert_array_equal(got, ref_t.lookup_codes(codes, IN_F))
    ref_fn = ref_serve.lower_tables(ref_t, IN_F, x_width=IN_F + IN_I + 1)
    np.testing.assert_array_equal(got, np.asarray(jax.device_get(ref_fn(codes)), np.int64))


def test_lower_tables_pruned_cell_with_large_f_out():
    from repro.core.tables import LayerTables as RefLayerTables

    g = lambda a: np.asarray(a, np.int32)
    t = RefLayerTables(f_in=g([[1, 1]]), i_in=g([[1, 1]]), f_out=g([[1, 7]]),
                    i_out=g([[1, -8]]), in_width=g([[3, 0]]), out_width=g([[3, 0]]),
                    codes=np.arange(16).reshape(1, 2, 8).astype(np.int64) % 5
                    * np.asarray([1, 0])[None, :, None])
    codes = np.arange(-4, 4, dtype=np.int64)[:, None]
    fn = lower_tables(LayerTables(**vars(t)), 1, x_width=4, device="cpu")
    np.testing.assert_array_equal(_host(fn(codes)), t.lookup_codes(codes, 1))


# ------------------------------------------------------------ shift edges
def _wrap(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _shift_round_exact(v: int, shift: int, bits: int) -> int:
    """``v * 2**shift`` in ``bits``-bit two's complement, round half to even
    on dropped bits; left shifts past the width give 0.  (At a right shift
    of ``bits - 1`` the integer ops' half overflows; there only the
    reference's own result is held.)"""
    if shift >= 0:
        return 0 if shift >= bits else _wrap(v << shift, bits)
    s = -shift
    floor = v >> s
    rem = v - (floor << s)
    half = 1 << (s - 1)
    if rem > half or (rem == half and floor & 1):
        floor += 1
    return _wrap(floor, bits)


@pytest.mark.parametrize("dtype,bits", [(torch.int32, 32), (torch.int64, 64)])
def test_shift_round_at_the_top_bit(dtype, bits):
    top = 1 << (bits - 2)
    vals = [0, 1, -1, 3, -3, 5, -6, top - 1, top, -top, 2 * top - 1, -2 * top,
            (1 << 20) + (1 << 19), -(1 << 20) - (1 << 19)]
    shifts = [0, 1, 2, -1, -2, -3, bits - 2, bits - 1, -(bits - 2), -(bits - 1), 40 % bits]
    v = torch.tensor(vals, dtype=dtype)[:, None]
    s = torch.tensor(shifts, dtype=dtype)[None, :]
    got = _shift_round(v, s).tolist()
    for a, row in zip(vals, got):
        for b, g in zip(shifts, row):
            if b > -(bits - 1):
                assert g == _shift_round_exact(a, b, bits), (a, b)
    jdt = jnp.int32 if bits == 32 else jnp.int64
    with jax.enable_x64(bits == 64):      # the reference's jnp version, bit for bit
        ref = ref_serve._shift_round(jnp.asarray(vals, jdt)[:, None],
                                     jnp.asarray(shifts, jdt)[None, :])
        assert np.asarray(ref).tolist() == got


@pytest.mark.parametrize("mode", ["SAT", "WRAP"])
@pytest.mark.parametrize("dtype,width_max", [(torch.int32, 30), (torch.int64, 62)])
def test_requant_cols_at_the_top_of_the_engine_range(mode, dtype, width_max):
    from repro.core.dais import _requant

    rng = np.random.default_rng(7)
    n = 24
    width = rng.integers(width_max - 3, width_max + 1, n)
    signed = rng.integers(0, 2, n).astype(bool)
    shift = rng.integers(-4, 3, n)
    shift[:4] = (0, 1, -1, 2)
    span = 1 << (width_max - 2)
    v = rng.integers(-span, span, (33, n))
    v[0] = span - 1
    v[1] = -span
    v[2] = 0
    i = width - signed - 7                    # f = 7 on every column
    want = np.stack([_requant(v[:, c], 7 - int(shift[c]), 7, int(i[c]), bool(signed[c]),
                              mode) for c in range(n)], axis=-1)
    got = _requant_cols(torch.as_tensor(v).to(dtype), torch.as_tensor(shift).to(dtype),
                        torch.as_tensor(width).to(dtype), torch.as_tensor(signed), mode)
    np.testing.assert_array_equal(_host(got), want)


@pytest.mark.parametrize("top", [27, 28, 29, 30])
def test_generic_program_with_values_at_the_top_of_the_dtype(top):
    """A CMUL and an ADD/SUB alignment shift of 3 put values at 2**top: up to
    top = 28 the proven width keeps an int32 engine whose values reach its
    top bits, past it the engine is int64; the dtype is the reference's
    (with 64-bit jax) and the outputs are the interpreter's."""
    from repro.core.dais import Reg

    ref = RefDaisProgram()
    ref.input_f = [0, 3]
    ref.input_signed = [True, True]
    a = ref.emit("IN", (0,), Reg(0, 8, True))
    b = ref.emit("IN", (1,), Reg(3, 8, True))
    big = ref.emit("CMUL", (a, 1 << (top - 10), 0), Reg(0, top - 2, True))
    s = ref.emit("ADD", (b, big), Reg(3, top + 2, True))
    d = ref.emit("SUB", (big, b), Reg(3, top + 2, True))
    r = ref.emit("REQUANT", (s, 0, top - 1, True, "SAT", 3), Reg(0, top, True))
    w = ref.emit("REQUANT", (d, 1, top - 3, True, "WRAP", 3), Reg(1, top - 1, True))
    ref.outputs = [s, d, r, w]
    ref.output_f = [3, 3, 0, 1]
    prog = DaisProgram.from_arrays(ref.to_arrays())
    codes = np.stack(np.meshgrid(np.arange(-128, 128), np.arange(-128, 128)),
                     -1).reshape(-1, 2)
    want = ref.run(codes)
    assert np.abs(want[:, 0]).max() >= 1 << top
    eng = compile_program(prog, device="cpu", engine="groups")
    with jax.enable_x64(True):
        ref_eng = ref_serve.compile_program(ref, fuse_layers=False)
        np.testing.assert_array_equal(np.asarray(ref_eng.run(codes), np.int64), want)
    assert str(eng.dtype).replace("torch.", "") == np.dtype(ref_eng.dtype).name
    assert eng.dtype == (torch.int32 if top <= 28 else torch.int64)
    np.testing.assert_array_equal(_host(eng.run(codes)), want)
