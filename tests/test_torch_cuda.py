"""Kernels B1-B4 on the card against their plain versions, and one fused
train step on the card against the same step through the plain versions.

Every test here needs an NVIDIA sm_90 card (the H100) and ``nvcc``; without
one they skip.  Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (sm_90) card; none is visible")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (H100)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("ci,co,bn", [(16, 20, True), (20, 5, False)])
def test_b2_kernel_matches_plain(device, ci, co, bn):
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import lut_dense_ref

    gen = torch.Generator().manual_seed(0)
    layer = LUTDense(ci, co, hidden=8, use_batchnorm=bn, device=device,
                     generator=gen)
    args = layer.kernel_args()
    x = (torch.randn((4099, ci), generator=gen) * 4).to(device)
    before = ops.launch_counts()["lut_dense"]
    got = ops.lut_dense(x, *args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lut_dense"] == before + 1
    # same float32 ops in the same order on the card: identical
    torch.testing.assert_close(got, lut_dense_ref(x, *args), rtol=0, atol=0)


def test_b4_engine_matches_interpreter(device):
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.serve.api import EngineSpec, build

    layers = build_lut_stack([16, 20, 5], 8, device=device,
                             generator=torch.Generator().manual_seed(0))
    prog = compile_sequential(layers, 4, 2)
    built = build(prog, EngineSpec(engine="pallas", require="pallas"),
                  device=device)
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(0).integers(lo, hi + 1, (16600, len(lo)))
    before = ops.launch_counts()["lut_serve"]
    out = built.engine.run(codes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lut_serve"] == before + 1
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64),
                                  prog.run(codes))


def test_b4_engine_built_on_cuda_without_an_index(device):
    """Entry points pass ``torch.device("cuda")``; the chain must accept the
    ``cuda:0`` tensors that device gives."""
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.serve.api import EngineSpec, build

    layers = build_lut_stack([16, 20, 5], 8, device="cuda",
                             generator=torch.Generator().manual_seed(1))
    prog = compile_sequential(layers, 4, 3)
    built = build(prog, EngineSpec(engine="pallas", require="pallas"),
                  device=torch.device("cuda"))
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(1).integers(lo, hi + 1, (999, len(lo)))
    np.testing.assert_array_equal(
        built.engine.run(codes).cpu().numpy().astype(np.int64), prog.run(codes))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_b4_synthetic_chain_matches_plain(device, dtype):
    from chip_smoke import synthetic_chain
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, run_chain,
                                                    run_chain_plain)

    rng = np.random.default_rng(1)
    packed = synthetic_chain(rng, dtype)
    chain = PackedChain(packed, dtype, device)
    x = torch.as_tensor(rng.integers(-2 ** 10, 2 ** 10, (777, packed.n_cols0)),
                        device=device).to(dtype)
    assert torch.equal(run_chain(chain, x), run_chain_plain(chain, x))


def test_b1_bit_exact_in_every_mode(device):
    from chip_smoke import b1_cases
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fake_quant_ref

    for label, x, f, i, signed, overflow in b1_cases(np.random.default_rng(2), device):
        before = ops.launch_counts()["fake_quant"]
        got = ops.fake_quant(x, f, i, signed=signed, overflow=overflow)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fake_quant"] == before + 1
        want = fake_quant_ref(x, f, i, signed, overflow)
        # every step is exact on a power-of-two grid: identical bit patterns
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), label


def test_b1_rejects_a_width_shape_it_would_have_to_broadcast(device):
    from repro_torch.kernels import ops

    x = torch.zeros((8, 4, 3), device=device)
    with pytest.raises(ValueError, match="trailing shape"):
        ops.fake_quant(x, torch.zeros((4, 1), device=device), 2.0)


@pytest.mark.parametrize("ci,co,bn", [(16, 20, True), (20, 5, False)])
def test_b3_matches_plain_and_is_deterministic(device, ci, co, bn):
    from chip_smoke import B3_REL, b3_args, b3_max_rel_err
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.kernels.ref import lut_dense_bwd_ref

    layer = LUTDense(ci, co, hidden=8, use_batchnorm=bn, device=device,
                     generator=torch.Generator().manual_seed(3))
    x, args, g = b3_args(layer, np.random.default_rng(3), 4099, device)   # ragged
    before = ops.launch_counts()["lut_dense_bwd"]
    got = lut_dense_bwd_fused(x, *args, g)
    again = lut_dense_bwd_fused(x, *args, g)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lut_dense_bwd"] == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    rel = b3_max_rel_err(got, lut_dense_bwd_ref(x, *args, g))
    assert max(rel.values()) <= B3_REL, rel


def test_fused_train_step_on_card_matches_plain(device, monkeypatch):
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_lut_train_step

    monkeypatch.setattr(chip_smoke, "JSC_BATCH", 2048)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "N_TRAIN", 8192)
    layers, hp, data = chip_smoke.train_setup(device)
    batch = chip_smoke.train_batch(data, 0)
    chip_smoke.compare_step_to_plain(layers, hp, batch)     # raises on a mismatch
    step_fn, init_fn = make_lut_train_step(layers, hp)
    ops.reset_launch_counts()
    opt, m = step_fn(init_fn(), batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"fake_quant": 2, "lut_dense": 1,
                                   "lut_dense_bwd": 1, "lut_serve": 0}
    assert bool(torch.isfinite(m["loss"]))
