"""``LayerTables.lookup_codes``, ``ServeEngine.run_float`` and
``FusedStages.n_table_entries`` against the reference's, and the zoo's
constructors, which build on the card unless the CPU is asked for.

* ``lookup_codes`` bit for bit: random tables with pruned cells (m <= 0),
  negative input codes, heterogeneous ``f_out`` and scalar or per-channel
  ``x_f``; and the tables of a JSC-HLF stack trained by the port, chained
  through both layers;
* ``run_float`` equal to the reference's ``DaisProgram.run_float`` on the
  trained JSC-HLF program and the reference's pid program at ctx 40, on
  every engine path, with floats off the input grid and on its ties;
* ``n_table_entries`` equal to the reference's, before and after the
  dead-cell pass;
* ``build_model`` with no ``device`` and no card raises (skipped where a
  card is present: ``tests/test_torch_cuda.py`` holds that case).
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro.core.opt import eliminate_dead_cells as ref_eliminate_dead_cells
from repro.core.tables import LayerTables as RefLayerTables
from repro.kernels.lut_serve import compose_fused_stages as ref_compose
from repro_torch.core.dais import DaisProgram
from repro_torch.core.opt import eliminate_dead_cells
from repro_torch.core.tables import LayerTables, extract_tables
from repro_torch.kernels.lut_serve import (compile_program, compose_fused_stages,
                                           input_code_bounds)
from test_torch_opt import IN_F, REF_PROGRAMS, _trained_jsc

torch.set_num_threads(2)

# one config of each family: lm, moe, vlm, hybrid, ssm, encdec
ZOO = ("olmo_1b", "phi35_moe", "internvl2_26b", "zamba2_12b", "rwkv6_16b", "whisper_base")


@pytest.fixture(scope="module")
def trained_jsc():
    return _trained_jsc()


def _ref_tables(t: LayerTables) -> RefLayerTables:
    return RefLayerTables(**{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})


def _random_tables(seed, ci=6, co=5, max_m=6) -> LayerTables:
    rng = np.random.default_rng(seed)
    m = rng.integers(0, max_m + 1, (ci, co))
    m[0, :2] = 0                                          # pruned cells
    f_in = rng.integers(-2, 5, (ci, co))
    f_out = rng.integers(-1, 6, (ci, co))                 # heterogeneous grids
    n = np.where(m > 0, rng.integers(1, 9, (ci, co)), 0)
    codes = rng.integers(-2 ** 7, 2 ** 7, (ci, co, 2 ** max_m))
    codes[m == 0] = 0
    i32 = lambda a: np.asarray(a, np.int32)
    return LayerTables(f_in=i32(f_in), i_in=i32(np.maximum(m, 1) - f_in - 1),
                       f_out=i32(f_out), i_out=i32(np.maximum(n, 1) - f_out - 1),
                       in_width=i32(m), out_width=i32(n), codes=codes.astype(np.int64))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("per_channel", [False, True])
def test_lookup_codes_random_tables(seed, per_channel):
    t = _random_tables(seed)
    rng = np.random.default_rng(100 + seed)
    x_f = rng.integers(-1, 4, t.c_in) if per_channel else int(rng.integers(-1, 4))
    x = rng.integers(-300, 300, (7, 3, t.c_in)).astype(np.int64)
    x[0, 0] = -1                                          # all-ones low bits
    got = t.lookup_codes(x, x_f)
    want = _ref_tables(t).lookup_codes(x, x_f)
    assert got.shape == (7, 3, t.c_out) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert t.common_f_out() == _ref_tables(t).common_f_out()


def test_lookup_codes_trained_jsc_stack(trained_jsc):
    """Both layers of the trained stack, layer 1 fed layer 0's output on its
    common grid (per-channel x_f there), with layer 1's widths pruned as the
    β-regulariser prunes them: cells with m = 0 and n = 0, and heterogeneous
    output grids."""
    layers, prog = trained_jsc
    layers = [copy.deepcopy(layer) for layer in layers]
    rng = np.random.default_rng(2)
    q_in, q_out = layers[1].q_in, layers[1].q_out
    with torch.no_grad():
        q_out["f"].copy_(torch.as_tensor(rng.integers(2, 7, q_out["f"].shape)))
        dead_in = torch.as_tensor(rng.random(q_in["i"].shape) < 0.2)
        q_in["i"][dead_in] = -q_in["f"][dead_in] - 1
        dead_out = torch.as_tensor(rng.random(q_out["i"].shape) < 0.2)
        q_out["i"][dead_out] = -q_out["f"][dead_out] - 1
    tables = [extract_tables(layer) for layer in layers]
    assert (tables[1].in_width == 0).any() and (tables[1].out_width == 0).any()
    assert len(np.unique(tables[1].f_out)) > 1
    lo, hi = input_code_bounds(prog)
    x = np.random.default_rng(3).integers(lo, hi + 1, (512, len(lo))).astype(np.int64)
    x_f = IN_F
    for k, t in enumerate(tables):
        got, want = t.lookup_codes(x, x_f), _ref_tables(t).lookup_codes(x, x_f)
        np.testing.assert_array_equal(got, want, err_msg=f"layer {k}")
        x, x_f = got, np.full(t.c_out, t.common_f_out())


def _float_inputs(prog, n, seed):
    """Floats near the input grid's codes, some on its half-way ties (which
    round half to even and stay in range)."""
    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(seed)
    codes = rng.integers(lo, hi + 1, (n, len(lo)))
    off = rng.choice([-0.5, -0.3, 0.0, 0.25, 0.45], codes.shape)
    off = np.where((off == -0.5) & (codes == lo), 0.0, off)
    return (codes + off) * np.exp2(-np.asarray(prog.input_f, np.float64))


def _programs(trained_jsc):
    _layers, prog = trained_jsc
    pid = REF_PROGRAMS["pid40"]()
    return {"jsc_hlf": (prog, RefDaisProgram.from_arrays(prog.to_arrays())),
            "pid40": (DaisProgram.from_arrays(pid.to_arrays()), pid)}


@pytest.mark.parametrize("name", ["jsc_hlf", "pid40"])
@pytest.mark.parametrize("engine", ["pallas", "fused", "groups"])
def test_run_float_equals_the_reference(trained_jsc, name, engine):
    prog, ref = _programs(trained_jsc)[name]
    eng = compile_program(prog, device="cpu", engine=engine)
    x = _float_inputs(prog, 300, 5)
    got = eng.run_float(x)
    want = ref.run_float(x)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(eng.run_float(x[0]), want[:1])     # one row


@pytest.mark.parametrize("case", ["random_pruning_0", "dead_rows", "conv_rows", "pid40",
                                  "trained_jsc"])
def test_n_table_entries_equals_the_reference(trained_jsc, case):
    if case == "trained_jsc":
        prog = trained_jsc[1]
        ref = RefDaisProgram.from_arrays(prog.to_arrays())
    else:
        ref = REF_PROGRAMS[case]()
        prog = DaisProgram.from_arrays(ref.to_arrays())
    counts = []
    for p, r in ((prog, ref), (eliminate_dead_cells(prog)[0],
                               ref_eliminate_dead_cells(ref)[0])):
        stages, why = compose_fused_stages(p)
        ref_stages, ref_why = ref_compose(r)
        assert stages is not None and ref_stages is not None, (why, ref_why)
        assert stages.n_table_entries() == ref_stages.n_table_entries()
        counts.append(stages.n_table_entries())
    assert counts[1] <= counts[0]
    if case in ("dead_rows", "trained_jsc"):             # rows die whole there
        assert counts[1] < counts[0]


# --------------------------------------------------------------------------- #
# the zoo's device
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ZOO)
def test_build_model_with_no_card_raises(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py builds on it")
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_smoke(arch))
    assert build_model(get_smoke(arch), device="cpu").device == torch.device("cpu")


def test_model_device_follows_its_argument_or_the_mesh():
    from repro_torch.models.lm import model_device
    from repro_torch.nn.base import Aux
    from repro_torch.nn.params import PDef, init_params

    cpu_mesh = types.SimpleNamespace(device_type="cpu")
    assert model_device(None, cpu_mesh) == torch.device("cpu")
    assert model_device("meta", cpu_mesh) == torch.device("meta")
    assert model_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        for args in ((), (None, types.SimpleNamespace(device_type="cuda")), ("cuda",)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                model_device(*args)
    # no CPU default below the constructors either
    with pytest.raises(TypeError):
        init_params({"w": PDef((2, 3), (None, None))}, None)
    with pytest.raises(TypeError):
        Aux.zero()
    assert init_params({"w": PDef((2, 3), (None, None))}, None, "meta")["w"].is_meta
