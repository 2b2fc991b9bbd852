"""Port parity for the compile path: truth tables, DAIS lowering, static
analysis, fused-stage composition and packing.

Every integer artifact must be bit-exact against the JAX package:

* lowering the reference's own ``LayerTables`` gives identical
  ``DaisProgram.to_arrays()``;
* ``verify_program``, the interval ranges, ``engine_width``, the ``live``
  masks, ``FusedStages`` and ``PackedStages`` of the same program are
  identical, on the JSC-HLF stack and on the reference's pid-hybrid conv
  program (sum stages, relu epilogues, the zero column);

and ``extract_tables`` from the same parameters gives the same codes up to
counted one-code flips (the MLP runs in float32 through torch's ``tanh``
instead of XLA's; see ``test_torch_lut_dense.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analysis import analyze_ranges as ref_analyze_ranges
from repro.core.dais import compile_sequential as ref_compile_sequential
from repro.core.lut_layers import LUTDense as RefLUTDense
from repro.kernels.lut_serve import compose_fused_stages as ref_compose
from repro.kernels.lut_serve_pallas import pack_stages as ref_pack
from repro_torch.core import lower as port_lower
from repro_torch.core.analysis import VerifyError, analyze_ranges, verify_program
from repro_torch.core.dais import DaisProgram
from repro_torch.core.lut_layers import LUTDense
from repro_torch.core.tables import LayerTables, extract_tables
from repro_torch.interop import lut_dense_params_from_numpy
from repro_torch.kernels.lut_serve import compose_fused_stages, engine_width
from repro_torch.kernels.lut_serve_cuda import pack_stages

torch.set_num_threads(2)

IN_F, IN_I = 4, 2
DIMS = (16, 20, 5)
HIDDEN = 8
# at most this share of table entries may flip by one code (measured: none
# over the 2 x 10^5 entries of this stack)
ENTRY_FLIP_FRAC = 1e-4


def _jsc_params(seed=0):
    """Reference JSC-HLF params: heterogeneous widths, a few width-pruned
    cells, non-trivial BN stats."""
    layers = [RefLUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0))
              for k, (ci, co) in enumerate(zip(DIMS[:-1], DIMS[1:]))]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(layers))
    rng = np.random.default_rng(seed)
    params = []
    for layer, key in zip(layers, keys):
        p = jax.tree_util.tree_map(np.asarray, layer.init(key))
        grid = (layer.c_in, layer.c_out)
        f_in = rng.integers(1, 6, grid).astype(np.float64)
        f_in[rng.random(grid) < 0.05] = -8.0            # width-pruned cells
        p["q_in"] = {"f": f_in, "i": rng.integers(0, 4, grid) + 0.2}
        p["q_out"] = {"f": rng.integers(1, 6, grid) - 0.2,
                      "i": rng.integers(0, 3, grid) + 0.1}
        if layer.use_batchnorm:
            p["bn_mean"] = rng.normal(0, 0.3, grid)
            p["bn_var"] = rng.uniform(0.3, 2.0, grid)
        params.append(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), p))
    return layers, params


@pytest.fixture(scope="module")
def jsc():
    layers, params = _jsc_params()
    prog = ref_compile_sequential(
        layers, [jax.tree_util.tree_map(jnp.asarray, p) for p in params],
        IN_F, IN_I)
    port = [lut_dense_params_from_numpy(
        LUTDense(l.c_in, l.c_out, hidden=HIDDEN, use_batchnorm=l.use_batchnorm,
                 device="cpu", generator=torch.Generator().manual_seed(0)), p)
        for l, p in zip(layers, params)]
    return prog, port


@pytest.fixture(scope="module")
def pid():
    """The reference's hybrid PID conv program at a two-window context."""
    from repro.core.lower import lower
    from repro.models.pid import (build_pid_graph, build_pid_layers,
                                  init_pid_params)

    layers = build_pid_layers(hidden=4)
    params = init_pid_params(layers, jax.random.PRNGKey(3))
    return lower(build_pid_graph(layers, n_samples=40), [*params, None])


@pytest.fixture(params=["jsc", "pid"])
def ref_prog(request):
    if request.param == "jsc":
        return request.getfixturevalue("jsc")[0]
    return request.getfixturevalue("pid")


def _assert_arrays_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_lowering_reference_tables_is_identical(jsc, monkeypatch):
    prog, port = jsc
    ref_tables = iter(prog.tables[k] for k in sorted(prog.tables))

    def reference_tables(layer):
        t = next(ref_tables)
        return LayerTables(**{f.name: getattr(t, f.name)
                              for f in LayerTables.__dataclass_fields__.values()})

    monkeypatch.setattr(port_lower, "extract_tables", reference_tables)
    got = port_lower.compile_sequential(port, IN_F, IN_I)
    _assert_arrays_equal(got.to_arrays(), prog.to_arrays())


def test_extract_tables_matches_reference(jsc):
    prog, port = jsc
    n_flip = n_entries = 0
    for lid, layer in enumerate(port):
        want = prog.tables[lid]
        got = extract_tables(layer)
        for fld in ("f_in", "i_in", "f_out", "i_out", "in_width", "out_width"):
            np.testing.assert_array_equal(getattr(got, fld), getattr(want, fld))
        assert got.codes.shape == want.codes.shape
        d = got.codes - want.codes
        assert np.all(np.abs(d) <= 1), "a table entry moved by more than one code"
        n_flip += int(np.count_nonzero(d))
        n_entries += d.size
        assert got.n_luts() == want.n_luts() and got.n_luts() < d.shape[0] * d.shape[1]
    assert n_flip <= ENTRY_FLIP_FRAC * n_entries, n_flip


def test_wire_format_round_trip(ref_prog):
    arrays = ref_prog.to_arrays()
    prog = DaisProgram.from_arrays(arrays)
    _assert_arrays_equal(prog.to_arrays(), arrays)
    x = np.random.default_rng(0).integers(-8, 8, (64, len(prog.input_f)))
    if not all(prog.input_signed):
        x = np.abs(x)
    np.testing.assert_array_equal(prog.run(x), ref_prog.run(x))
    assert prog.required_width() == ref_prog.required_width()


def test_verifier_and_ranges_identical(ref_prog):
    prog = DaisProgram.from_arrays(ref_prog.to_arrays())
    assert verify_program(prog) == []
    got, want = analyze_ranges(prog), ref_analyze_ranges(ref_prog)
    for fld in ("lo", "hi", "transient_lo", "transient_hi"):
        assert getattr(got, fld) == getattr(want, fld), fld
    assert got.proven_width() == want.proven_width()
    assert got.engine_width() == want.engine_width() == engine_width(prog)


def test_verifier_rejects_broken_program(jsc):
    arrays = jsc[0].to_arrays()
    arrays["outputs"] = arrays["outputs"].copy()
    arrays["outputs"][0] = len(arrays["instr_op"]) + 5       # dangling
    with pytest.raises(VerifyError):
        verify_program(DaisProgram.from_arrays(arrays))


def _assert_stage_equal(got, want, fields):
    for fld in fields:
        a, b = getattr(got, fld), getattr(want, fld)
        if b is None:
            assert a is None, fld
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (fld, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=fld)
    assert len(got.epilogue) == len(want.epilogue)
    for e, f in zip(got.epilogue, want.epilogue):
        assert (e.op, e.mode) == (f.op, f.mode)
        np.testing.assert_array_equal(e.params, f.params)


def _stages(ref_prog):
    prog = DaisProgram.from_arrays(ref_prog.to_arrays())
    got, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    want, why_ref = ref_compose(ref_prog, ranges=ref_analyze_ranges(ref_prog))
    assert got is not None and want is not None, (why, why_ref)
    return got, want


def test_fused_stages_identical(ref_prog):
    got, want = _stages(ref_prog)
    assert got.n_stages() == want.n_stages()
    np.testing.assert_array_equal(got.out_cols, want.out_cols)
    for a, b in zip(got.stages, want.stages):
        assert (a.kind, a.n_cols) == (b.kind, b.n_cols)
        _assert_stage_equal(a, b, ("gather", "bias", "in_shift", "mask", "table",
                                   "out_shift", "shifts", "signs", "live"))
    assert {s.kind for s in got.stages} >= {"lut"}


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_packed_stages_identical(ref_prog, dtype):
    got_fs, want_fs = _stages(ref_prog)
    got = pack_stages(got_fs, getattr(torch, dtype))
    want = ref_pack(want_fs, getattr(jnp, dtype))
    assert got.n_cols0 == want.n_cols0 and got.n_stages() == want.n_stages()
    np.testing.assert_array_equal(got.out_cols, want.out_cols)
    assert got.table_bytes() == want.table_bytes()
    assert got.resident_bytes() == want.resident_bytes()
    for a, b in zip(got.stages, want.stages):
        assert (a.kind, a.n_cols) == (b.kind, b.n_cols)
        _assert_stage_equal(a, b, ("gather", "bias", "in_shift", "mask",
                                   "table", "coef"))
