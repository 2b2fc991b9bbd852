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
    """Every case of ``chip_smoke.b1_cases`` (width modes, expand views, a
    copied stride-0 middle axis, edge values and widths) through
    ``FakeQuant``'s forward: one launch each, identical bit patterns."""
    from chip_smoke import b1_cases
    from repro_torch.core.quant import _fq_forward
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fake_quant_ref

    for label, x, f, i, signed, overflow in b1_cases(np.random.default_rng(2), device):
        before = ops.launch_counts()["fake_quant"]
        got = _fq_forward(x, f, i, signed, overflow)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fake_quant"] == before + 1, label
        want = fake_quant_ref(x, f, i, signed, overflow)
        # every step is exact on a power-of-two grid: identical bit patterns
        assert got.is_contiguous() and got.shape == x.shape, label
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), label


def test_b1_reads_the_expand_view_in_place_and_refuses_other_strides(device):
    from repro_torch.kernels import ops

    src = torch.randn((999, 6), device=device) * 8
    f = torch.full((6, 5), 3.0, device=device)
    i = torch.full((6, 5), 2.0, device=device)
    view = src[:, :, None].expand(999, 6, 5)
    got = ops.fake_quant(view, f, i, signed=True, overflow="WRAP")
    want = ops.fake_quant(view.contiguous(), f, i, signed=True, overflow="WRAP")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="expanded along its last axis"):
        ops.fake_quant(src[:, None, :].expand(999, 5, 6), f.T, i.T)


def test_b1_rejects_a_width_shape_it_would_have_to_broadcast(device):
    from repro_torch.kernels import ops

    x = torch.zeros((8, 4, 3), device=device)
    with pytest.raises(ValueError, match="trailing shape"):
        ops.fake_quant(x, torch.zeros((4, 1), device=device), 2.0)


@pytest.mark.parametrize("ci,co,bn", [(16, 20, True), (20, 5, False)])
def test_b3_matches_plain_and_is_deterministic(device, ci, co, bn):
    """B3 at the JSC layer shapes with a ragged batch, then one cell at a
    time at the edge widths f = +-127, i = -127 (chip_smoke.B3_EDGE_IN/OUT),
    where the plain backward needs exact powers of two (ROADMAP C8): two
    launches bitwise equal, every gradient within B3_REL of the plain one."""
    from chip_smoke import B3_REL, b3_args, b3_edge_args, b3_max_rel_err
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.kernels.ref import lut_dense_bwd_ref

    layer = LUTDense(ci, co, hidden=8, use_batchnorm=bn, device=device,
                     generator=torch.Generator().manual_seed(3))
    x, args, g = b3_args(layer, np.random.default_rng(3), 4099, device)   # ragged
    cases = [("layer", x, args, g)] + b3_edge_args(np.random.default_rng(ci), 4099, device)
    for label, x, args, g in cases:
        before = ops.launch_counts()["lut_dense_bwd"]
        got = lut_dense_bwd_fused(x, *args, g)
        again = lut_dense_bwd_fused(x, *args, g)
        torch.cuda.synchronize()
        assert ops.launch_counts()["lut_dense_bwd"] == before + 2, label
        for a, b in zip(got, again):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), label
        assert all(bool(torch.isfinite(t).all()) for t in got), label
        rel = b3_max_rel_err(got, lut_dense_bwd_ref(x, *args, g))
        assert max(rel.values()) <= B3_REL, (label, rel)


@pytest.mark.parametrize("b,ci,co,h", [(3001, 3, 40, 8), (3001, 5, 20, 16), (999, 7, 3, 1),
                                        (2500, 2, 70, 4), (1, 4, 5, 8), (40000, 20, 2, 3)])
def test_b3_other_shapes(device, b, ci, co, h):
    """Hidden widths other than the path's, C_out past one chunk of the
    kernel's shared memory (several chunks of o), one row, and a batch whose
    splits are capped in rows: within B3_REL of the plain version."""
    from chip_smoke import B3_REL, b3_max_rel_err
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.kernels.ref import lut_dense_bwd_ref

    rng = np.random.default_rng(b + ci + co + h)
    shapes = [(b, ci), (ci, h, co), (ci, h, co), (ci, h, co), (ci, co)]
    scales = [3.0, 1.0, 0.5, (h * ci) ** -0.5 * 3, 0.2]
    args = [torch.as_tensor(rng.normal(0, s, sh), dtype=torch.float32, device=device)
            for s, sh in zip(scales, shapes)]
    for lo, hi in ((-1, 6), (-1, 4), (0, 6), (-1, 2)):
        args.append(torch.as_tensor(rng.integers(lo, hi, (ci, co)), dtype=torch.float32,
                                    device=device))
    g = torch.as_tensor(rng.normal(0, 1, (b, co)), dtype=torch.float32, device=device)
    got = lut_dense_bwd_fused(*args, g)
    again = lut_dense_bwd_fused(*args, g)
    for a, b_ in zip(got, again):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    rel = b3_max_rel_err(got, lut_dense_bwd_ref(*args, g))
    assert max(rel.values()) <= B3_REL, rel


def test_b3_graph_replay_equals_eager(device):
    """One B3 call captured in a CUDA graph and replayed gives the eager
    call's bits: the kernel resets its own counters."""
    from chip_smoke import b3_args
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    layer = LUTDense(20, 5, hidden=8, device=device,
                     generator=torch.Generator().manual_seed(4))
    x, args, g = b3_args(layer, np.random.default_rng(4), 16600, device)
    eager = [t.clone() for t in lut_dense_bwd_fused(x, *args, g)]   # before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lut_dense_bwd_fused(x, *args, g)
    for _ in range(3):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_b3_is_one_device_kernel(device):
    from chip_smoke import b3_args, device_kernels
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    layer = LUTDense(16, 20, hidden=8, device=device,
                     generator=torch.Generator().manual_seed(5))
    x, args, g = b3_args(layer, np.random.default_rng(5), 999, device)
    lut_dense_bwd_fused(x, *args, g)
    assert len(device_kernels(lambda: lut_dense_bwd_fused(x, *args, g))) == 1


@pytest.mark.parametrize("step", [0, 1, 29, 30, 99, 100, 150, 199, 1000])
def test_beta_and_lr_on_card_match_cpu(device, step):
    """The step counter lives on the card (ROADMAP C9), and beta and the
    learning rate computed there from it agree with the CPU's: the card's
    expf / logf / cosf differ from the CPU's in their last ulps.  beta is
    exp(u) with |u| near 14.5, so an ulp of u is 1e-6 of beta (chip_smoke
    measured up to 16 ulps of beta over 200 steps): beta holds to 4e-6 of
    itself.  lr holds to 1e-6 of itself plus 1e-6 of its peak, as the CPU
    parity against the reference in tests/test_torch_train.py (0.5 * (1 +
    cos) near the end of a cycle cancels)."""
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.optim.adam import adam_init, cosine_restarts

    assert adam_init({"w": torch.zeros(3, device=device)})["step"].device == device
    beta = BetaSchedule(5e-7, 1e-4, 200)
    sched = cosine_restarts(3e-3, first_period=100, warmup=30)
    for fn, rtol, atol in ((beta, 4e-6, 0.0), (sched, 1e-6, 1e-6 * 3e-3)):
        cpu = fn(torch.tensor(step, dtype=torch.int32))
        card = fn(torch.tensor(step, dtype=torch.int32, device=device))
        assert card.device == device and card.dtype == torch.float32
        np.testing.assert_allclose(float(card.cpu()), float(cpu), rtol=rtol, atol=atol)


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
