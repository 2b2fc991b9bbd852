"""Kernels B1-B4 on the card against their plain versions, and fused train
steps on the card (H = 8, and H = 24 past B3's unrolled instantiations)
against the same step through the plain versions.

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


def test_b2_bit_for_bit_at_the_path_shapes(device):
    """B2 at the JSC-HLF layers, B = 16600: every output's bits the plain
    version's, two launches alike, one launch counted a call."""
    from chip_smoke import b2_check, b2_path_inputs
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_dense import lut_dense_fused

    for (ci, co), x, args in b2_path_inputs(device):
        before = ops.launch_counts()["lut_dense"]
        b2_check(f"{ci}->{co}", lut_dense_fused, x, args)   # raises on a difference
        assert ops.launch_counts()["lut_dense"] == before + 2


def test_b2_bit_for_bit_in_every_case(device):
    """``chip_smoke.b2_cases``: one cell at a time at the edge widths f =
    +-127, i = -127 and dead cells; x with NaN, +-inf and codes past the
    WRAP guard; H in 1, 3, 8, 16, 17 (the generic instantiation); B in 1, 31,
    4099 by C_out in 1, 33.  Bit for bit, any NaN matching any NaN."""
    from chip_smoke import b2_cases, b2_check
    from repro_torch.kernels.lut_dense import lut_dense_fused

    for label, x, args in b2_cases(np.random.default_rng(9), device):
        b2_check(label, lut_dense_fused, x, args)


def test_b2_graph_replay_equals_eager(device):
    from chip_smoke import b2_graph_replay, b2_path_inputs
    from repro_torch.kernels.lut_dense import lut_dense_fused

    for _shape, x, args in b2_path_inputs(device):
        assert b2_graph_replay(lut_dense_fused, x, args)


def test_b2_is_one_device_kernel(device):
    from chip_smoke import b2_random_args, device_kernels
    from repro_torch.kernels.lut_dense import lut_dense_fused

    for hidden in (8, 17):
        x, args = b2_random_args(np.random.default_rng(hidden), 999, 16, 20, hidden, device)
        lut_dense_fused(x, *args)
        assert len(device_kernels(lambda: lut_dense_fused(x, *args))) == 1


def test_b2_planner_counts_the_kernels_shared_memory(device):
    """``block_smem`` (the planner's count, also used on the CPU) equals the
    shared memory ``csrc/lut_dense.cu`` gives a block, for every H kind."""
    from repro_torch.kernels.lut_dense import _lib, block_smem

    lib = _lib()
    for hidden in (1, 3, 8, 16, 17, 40):
        for rows in (32, 128, 512):
            for c_in in (1, 16, 20, 300):
                for o_chunk in (1, 5, 20, 32):
                    j_chunk, smem = block_smem(rows, c_in, o_chunk, hidden)
                    assert smem == lib.lut_dense_forward_smem(rows, j_chunk, o_chunk,
                                                              hidden)


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


@pytest.mark.parametrize("make", ["synthetic_chain", "wide_chain"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_b4_seeded_chains_match_plain_and_repeat(device, make, dtype):
    """The synthetic chain (sum stages, in-shifts, epilogues, four lanes) and
    the wide one (constants and a stage's tables in global memory, tiles of
    fewer than 32 rows in int64): bit for bit, two launches alike."""
    import chip_smoke
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, run_chain,
                                                    run_chain_plain)

    rng = np.random.default_rng(5)
    packed = getattr(chip_smoke, make)(rng, dtype)
    chain = PackedChain(packed, dtype, device)
    for b in (1, 31, 129, 1031):
        x = torch.as_tensor(rng.integers(-2 ** 10, 2 ** 10, (b, packed.n_cols0)),
                            device=device).to(dtype)
        got = run_chain(chain, x)
        assert torch.equal(got, run_chain_plain(chain, x)), b
        assert torch.equal(got, run_chain(chain, x)), b


def _jsc_chain(device, dims=(16, 20, 5), seed=0):
    import chip_smoke
    from repro_torch.core.lower import compile_sequential
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.serve.api import EngineSpec, build

    layers = build_lut_stack(list(dims), 8, device=device,
                             generator=torch.Generator().manual_seed(seed))
    prog = compile_sequential(layers, 4, 2)
    built = build(prog, EngineSpec(engine="pallas", require="pallas", verify="full",
                                   n_random=2048, seed=0), device=device)
    chain, packed = chip_smoke.plain_chain(prog, built.engine, device)
    return prog, built, chain


def test_b4_bit_for_bit_at_every_batch(device):
    """B4 on the JSC-HLF chain at B in 1, 31, 129, 1024, 4099, 16600, 66400:
    the plain chain's codes, two launches alike, one launch counted a call."""
    from chip_smoke import B4_BATCHES, b4_codes
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve_cuda import run_chain, run_chain_plain

    prog, _, chain = _jsc_chain(device)
    rng = np.random.default_rng(6)
    for b in B4_BATCHES:
        x = b4_codes(prog, rng, b, chain.dtype, device)
        before = ops.launch_counts()["lut_serve"]
        got = run_chain(chain, x)
        again = run_chain(chain, x)
        torch.cuda.synchronize()
        assert ops.launch_counts()["lut_serve"] == before + 2
        assert torch.equal(got, run_chain_plain(chain, x)), b
        assert torch.equal(got, again), b


def test_b4_graph_replay_and_one_device_kernel(device):
    from chip_smoke import b4_codes, b4_graph_replay, device_kernels
    from repro_torch.kernels.lut_serve_cuda import run_chain

    prog, _, chain = _jsc_chain(device, seed=2)
    for b in (1024, 16600):
        x = b4_codes(prog, np.random.default_rng(b), b, chain.dtype, device)
        assert b4_graph_replay(chain, x), b
        assert len(device_kernels(lambda: run_chain(chain, x))) == 1, b


def test_graph_kernels_counts_one_b4_node(device):
    """``device_kernels``' fallback when profiles record nothing: the call
    captured in a CUDA graph holds one B4 kernel node."""
    from chip_smoke import b4_codes, graph_kernels
    from repro_torch.kernels.lut_serve_cuda import run_chain

    prog, _, chain = _jsc_chain(device, seed=2)
    x = b4_codes(prog, np.random.default_rng(1024), 1024, chain.dtype, device)
    names = graph_kernels(lambda: run_chain(chain, x))
    assert len(names) == 1 and "lut_serve_chain_kernel" in names[0], names


def test_b4_global_and_resident_stages_in_one_launch(device):
    """A 16->64->5 stack: its first stage's 524 KB of tables cannot stay in
    shared memory and are read from global memory, its second stage's are
    staged; served behind the gate, bit for bit."""
    from chip_smoke import b4_codes
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain

    prog, built, chain = _jsc_chain(device, dims=(16, 64, 5), seed=3)
    assert chain.plan.table_soff[0] < 0 <= chain.plan.table_soff[1]
    x = b4_codes(prog, np.random.default_rng(7), 4099, chain.dtype, device)
    out = built.engine.run(x)
    assert torch.equal(out, run_chain_plain(chain, x))
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64),
                                  prog.run(x.cpu().numpy().astype(np.int64)))


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
    from chip_smoke import b3_args, b3_graph_replay
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    layer = LUTDense(20, 5, hidden=8, device=device,
                     generator=torch.Generator().manual_seed(4))
    x, args, g = b3_args(layer, np.random.default_rng(4), 16600, device)
    assert b3_graph_replay(lut_dense_bwd_fused, x, args, g)


@pytest.mark.parametrize("hidden", [17, 24, 32])
def test_b3_past_sixteen_hidden_matches_plain(device, hidden):
    """ROADMAP C10: B3's generic instantiation at the train path's 20->5
    layer, B = 16600: within B3_REL of the plain version, two launches
    bitwise equal, a graph replay equal to an eager call, one device kernel."""
    from chip_smoke import B3_REL, b3_args, b3_check, b3_graph_replay, device_kernels
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    layer = LUTDense(20, 5, hidden=hidden, device=device,
                     generator=torch.Generator().manual_seed(hidden))
    x, args, g = b3_args(layer, np.random.default_rng(hidden), 16600, device)
    rel = b3_check(f"H={hidden}", lut_dense_bwd_fused, x, args, g)   # raises past B3_REL
    assert max(rel[n] for n in rel if n != "max_abs") <= B3_REL
    assert b3_graph_replay(lut_dense_bwd_fused, x, args, g)
    assert len(device_kernels(lambda: lut_dense_bwd_fused(x, *args, g))) == 1


def test_b3_is_one_device_kernel(device):
    from chip_smoke import b3_args, device_kernels
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    layer = LUTDense(16, 20, hidden=8, device=device,
                     generator=torch.Generator().manual_seed(5))
    x, args, g = b3_args(layer, np.random.default_rng(5), 999, device)
    lut_dense_bwd_fused(x, *args, g)
    assert len(device_kernels(lambda: lut_dense_bwd_fused(x, *args, g))) == 1


@pytest.mark.parametrize("hidden", [8, 20])
@pytest.mark.parametrize("batch", [16600, 1024])
def test_bn_stats_pair_matches_plain_and_is_deterministic(device, batch, hidden):
    """The batch statistics' pair at the JSC layer 0 (16 -> 20, batch-norm)
    against its plain versions: the statistics within BN_STATS_REL, every
    gradient within B3_REL, two launches bitwise equal, one device kernel
    each, and one graph of the pair replayed equal to eager calls."""
    from chip_smoke import bn_args, bn_check, bn_graph_replay, device_kernels
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_dense import lut_bn_stats_fused
    from repro_torch.kernels.lut_dense_bwd import lut_bn_stats_grad_fused

    layer = LUTDense(16, 20, hidden=hidden, use_batchnorm=True, device=device,
                     generator=torch.Generator().manual_seed(batch + hidden))
    x, args, cot = bn_args(layer, np.random.default_rng(hidden), batch, device)
    before = ops.launch_counts()
    bn_check(f"B={batch} H={hidden}", x, args, cot)       # raises past the tolerances
    after = ops.launch_counts()
    assert after["lut_bn_stats"] - before["lut_bn_stats"] == 2
    assert after["lut_bn_stats_grad"] - before["lut_bn_stats_grad"] == 2
    mean, _ = lut_bn_stats_fused(x, *args)
    assert len(device_kernels(lambda: lut_bn_stats_fused(x, *args))) == 1
    assert len(device_kernels(lambda: lut_bn_stats_grad_fused(x, *args, mean, *cot))) == 1
    assert bn_graph_replay(x, args, cot)


@pytest.mark.parametrize("batch", [1, 31, 4099])
def test_bn_stats_pair_at_small_and_ragged_batches(device, batch):
    from chip_smoke import bn_args, bn_check
    from repro_torch.core.lut_layers import LUTDense

    layer = LUTDense(16, 20, hidden=8, use_batchnorm=True, device=device,
                     generator=torch.Generator().manual_seed(batch))
    bn_check(f"B={batch}", *bn_args(layer, np.random.default_rng(batch), batch, device))


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
    # layer 0's batch-norm trains on the statistics' pair and B2/B3: no B1
    assert ops.launch_counts() == chip_smoke.PER_STEP == {
        "fake_quant": 0, "lut_dense": 2, "lut_dense_bwd": 2, "lut_serve": 0,
        "lut_bn_stats": 1, "lut_bn_stats_grad": 1}
    assert bool(torch.isfinite(m["loss"]))


def test_fused_train_step_past_sixteen_hidden(device, monkeypatch):
    """ROADMAP C10: a train step of a JSC-HLF stack at H = 24 runs B2 and B3
    and the batch statistics' pair (all on their generic instantiations) and
    matches the plain step."""
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_lut_train_step

    monkeypatch.setattr(chip_smoke, "JSC_BATCH", 2048)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "N_TRAIN", 8192)
    layers, hp, data = chip_smoke.train_setup(device, hidden=24)
    batch = chip_smoke.train_batch(data, 0)
    chip_smoke.compare_step_to_plain(layers, hp, batch)     # raises on a mismatch
    step_fn, init_fn = make_lut_train_step(layers, hp)
    ops.reset_launch_counts()
    _, m = step_fn(init_fn(), batch)
    torch.cuda.synchronize()
    assert ops.launch_counts() == chip_smoke.PER_STEP
    assert bool(torch.isfinite(m["loss"]))


# ------------------------------------------------- the chunked loop (ROADMAP A1)
def _loop_setup(monkeypatch, device, steps=12):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "JSC_BATCH", 2048)
    monkeypatch.setattr(chip_smoke, "TRAIN_STEPS", steps)
    monkeypatch.setattr(chip_smoke, "N_TRAIN", 8192)
    layers, hp, data = chip_smoke.train_setup(device)
    return chip_smoke, layers, hp, data


def _copies(layers):
    import copy

    return [copy.deepcopy(layer) for layer in layers]


def test_graph_chunks_equal_eager_chunks(device, monkeypatch):
    """The chunked loop captured as CUDA graphs (k in {4, 2}, boundary 6)
    gives the eager chunks' bits: params, Adam state, BN stats, metrics."""
    from repro_torch.train.loop import run_chunked
    from repro_torch.train.steps import make_lut_train_step, named_params

    cs, layers0, hp, data = _loop_setup(monkeypatch, device)
    out = {}
    for mode in ("eager", "graph"):
        layers = _copies(layers0)
        step_fn, init_fn = make_lut_train_step(layers, hp)
        seen = []
        _, opt, m = run_chunked(step_fn, named_params(layers), init_fn(),
                                lambda s: cs.host_batch(data, s), 0, 12, chunk_steps=4,
                                boundaries=(6,), mode=mode,
                                on_chunk=lambda r: seen.append((r.step, r.k, r.compiled)))
        assert seen == [(0, 4, True), (4, 2, True), (6, 4, False), (10, 2, False)]
        out[mode] = (cs.state_bytes(layers, opt), {k: v.tobytes() for k, v in m.items()})
    assert out["graph"] == out["eager"]


def test_b3_scratch_outgrown_after_capture_keeps_replays_exact(device, monkeypatch):
    """ROADMAP C11: a graph captured with B3's scratch, then a B3 call at
    H = 32 that outgrows it (20 -> 40: more partial sums than the captured
    step's widest layer, 16 -> 20), then replays: the old scratch must
    still be there (the replay's tickets and partial sums), so replays
    equal eager."""
    import torch
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.data.pipeline import stack_batches
    from repro_torch.kernels import lut_dense_bwd
    from repro_torch.train.loop import make_chunked_step
    from repro_torch.train.steps import make_lut_train_step

    cs, layers0, hp, data = _loop_setup(monkeypatch, device)
    monkeypatch.setattr(lut_dense_bwd, "_WORKSPACE", {})   # sized by the capture below
    la, lb = _copies(layers0), _copies(layers0)
    sa, ia = make_lut_train_step(la, hp)
    sb, ib = make_lut_train_step(lb, hp)
    graph = make_chunked_step(sa, mode="graph", device=device)
    eager = make_chunked_step(sb, mode="eager", device=device)

    def chunk(step):
        return {n: torch.as_tensor(a, device=device)
                for n, a in stack_batches(lambda s: cs.host_batch(data, s), step, 3).items()}

    oa, ob = ia(), ib()
    oa, _ = graph(oa, chunk(0))                     # captures, then replays
    ob, _ = eager(ob, chunk(0))
    retired = len(lut_dense_bwd._RETIRED)
    big = LUTDense(20, 40, hidden=32, device=device, generator=torch.Generator().manual_seed(3))
    x, args, g = cs.b3_args(big, np.random.default_rng(3), 16600, device)
    lut_dense_bwd.lut_dense_bwd_fused(x, *args, g)  # outgrows the scratch
    assert len(lut_dense_bwd._RETIRED) == retired + 1
    # take whatever memory a freed scratch would have left, on the stream that
    # allocated it (the capture's warm-up stream) and on this one: nonzero
    # tickets and poisoned sums
    junk = []
    for stream in (graph.stream, torch.cuda.current_stream(device)):
        with torch.cuda.stream(stream):
            junk += [torch.full((64 << i,), 7, dtype=torch.int32, device=device)
                     for i in range(12)]
    torch.cuda.synchronize()
    for step in (3, 6):
        oa, ma = graph(oa, chunk(step))
        ob, mb = eager(ob, chunk(step))
        torch.cuda.synchronize()
        assert all(torch.equal(ma[k], mb[k]) for k in mb)
    assert cs.state_bytes(la, oa) == cs.state_bytes(lb, ob)
    assert all(bool((t == 7).all()) for t in junk)


def test_graph_replay_launch_count_equals_profiled_kernels(device, monkeypatch):
    """Launches counted for a replay (those recorded at capture, once per
    replay) equal the device kernels a profile of the replay sees: B2 and B3
    twice and the batch statistics' pair once per step."""
    import torch
    from repro_torch.data.pipeline import stack_batches
    from repro_torch.kernels import ops
    from repro_torch.train.loop import make_chunked_step
    from repro_torch.train.steps import make_lut_train_step

    cs, layers0, hp, data = _loop_setup(monkeypatch, device)
    step_fn, init_fn = make_lut_train_step(_copies(layers0), hp)
    chunk_fn = make_chunked_step(step_fn, mode="graph", device=device)
    batches = {n: torch.as_tensor(a, device=device)
               for n, a in stack_batches(lambda s: cs.host_batch(data, s), 0, 3).items()}
    state = {"opt": init_fn()}

    def call():
        state["opt"], _ = chunk_fn(state["opt"], batches)

    ops.reset_launch_counts()
    call()
    # the warm-up step and one replay of 3
    assert ops.launch_counts() == {n: 4 * c for n, c in cs.PER_STEP.items()}
    ops.reset_launch_counts()
    names = cs.device_kernels(call)
    counted = ops.launch_counts()
    assert cs.kernel_counts(names) == {n: 3 * c for n, c in cs.PER_STEP.items()
                                       if n in cs.KERNEL_MARKS}
    n_calls = counted["lut_dense"] // 6               # profiles taken (device_kernels retries)
    assert counted == {n: 3 * c * n_calls for n, c in cs.PER_STEP.items()}


@pytest.mark.parametrize("slow", ["copy", "get_batch"])
def test_prefetcher_never_rewrites_a_pinned_buffer_in_flight(device, slow):
    """Every chunk the prefetcher hands over equals the synchronous stack,
    with each copy held back on the device behind a sleep while the worker
    runs ahead (a buffer rewritten before its copy would corrupt a chunk),
    and with a slow ``get_batch`` against a fast consumer."""
    import time

    import torch
    from repro_torch.data.pipeline import HostPrefetcher, stack_batches

    def get_batch(step):
        if slow == "get_batch":
            time.sleep(0.005)
        rng = np.random.default_rng([7, step])
        return {"x": rng.normal(size=(4096, 16)).astype(np.float32),
                "y": np.full((4096,), step, np.int64)}

    class SlowCopy(HostPrefetcher):
        def _to_device(self, pinned):
            if slow == "copy":
                with torch.cuda.stream(self._copy_stream):
                    torch.cuda._sleep(20_000_000)    # ~10 ms before the copies start
            return super()._to_device(pinned)

    segments = [(3 * i, 3) for i in range(12)]
    with SlowCopy(get_batch, segments, depth=1, device=device) as pf:
        for step, k, chunk in pf:
            want = stack_batches(get_batch, step, k)
            for n, a in want.items():
                assert np.array_equal(chunk[n].cpu().numpy(), a), (step, n)


# ---------------------------------------------- the PID hybrid (ROADMAP A2)
def _pid_setup(monkeypatch, device, batch=32, steps=4):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PID_BATCH", batch)
    monkeypatch.setattr(chip_smoke, "PID_STEPS", steps)
    monkeypatch.setattr(chip_smoke, "PID_N_TRAIN", 4 * batch)
    monkeypatch.setattr(chip_smoke, "PID_N_TEST", 64)
    layers, data = chip_smoke.pid_setup(device)
    return chip_smoke, layers, data


@pytest.mark.parametrize("fused", [None, True], ids=["einsum", "fused"])
def test_pid_step_on_card_matches_plain(device, monkeypatch, fused):
    """A pid step at 3000-sample waveforms on the card against the same step
    through the plain versions: the example's path (B1 x8) and the LUT
    layers on the fused pair (B1 x2, B2 and B3 x3)."""
    cs, layers, data = _pid_setup(monkeypatch, device)
    wf, cnt = cs.pid_batch(data, 0)
    _cpu, _flips, _worst, got = cs.compare_pid_step_to_plain(layers, wf, cnt, fused)
    assert got == (cs.PID_FUSED_STEP if fused else cs.PID_PER_STEP)


def test_b1_bit_exact_at_the_pid_shapes(device):
    """B1 at the pid path's calls: per-channel SAT (128, 150, 20)/(20,),
    per-element SAT (20, 8), the LUT-Convs' 4-D expand-view WRAP and SAT."""
    from chip_smoke import b1_check, pid_b1_cases

    for case in pid_b1_cases(np.random.default_rng(21), device):
        b1_check(*case)                                  # raises on a difference


@pytest.mark.parametrize("ctx,b", [(100, 1024), (100, 16600), (3000, 1024)])
def test_b4_on_the_pid_chain_matches_plain(device, ctx, b):
    """B4 on the untrained hybrid's chain (the front's 1.31 MB table in
    global memory; at ctx 3000 every table but the head's, and 13-row
    tiles): equal to the plain chain and the interpreter, a graph replay
    equal to an eager call."""
    import chip_smoke
    from repro_torch.core.lower import lower
    from repro_torch.kernels.lut_serve_cuda import run_chain, run_chain_plain
    from repro_torch.models.pid import build_pid_graph, build_pid_layers
    from repro_torch.serve.api import EngineSpec, build

    layers = build_pid_layers(device=device, generator=torch.Generator().manual_seed(0))
    prog = lower(build_pid_graph(layers, n_samples=ctx))
    built = build(prog, EngineSpec(engine="pallas", require="pallas", n_random=256),
                  device=device)
    chain, _packed = chip_smoke.plain_chain(prog, built.engine, device)
    assert chain.plan.table_soff[0] < 0                  # the front reads global memory
    x = chip_smoke.b4_codes(prog, np.random.default_rng(ctx), b, built.engine.dtype, device)
    got = run_chain(chain, x)
    torch.cuda.synchronize()
    assert torch.equal(got, run_chain_plain(chain, x))
    assert torch.equal(got, built.engine.run(x))
    rows = x[:64].cpu().numpy().astype(np.int64)
    np.testing.assert_array_equal(got[:64].cpu().numpy().astype(np.int64), prog.run(rows))
    assert chip_smoke.b4_graph_replay(chain, x)


# ------------------------------------------- generic runner, DCE, RTL, narrow
def _jsc_program(device):
    from repro_torch.core.lower import compile_sequential
    from repro_torch.launch.serve import build_lut_stack

    layers = build_lut_stack([16, 20, 5], 8, device=device,
                             generator=torch.Generator().manual_seed(0))
    for layer in layers:
        layer.eval()
    return compile_sequential(layers, 4, 2)


def _in_range(prog, b, seed):
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(prog)
    return np.random.default_rng(seed).integers(lo, hi + 1, (b, len(lo)))


@pytest.mark.parametrize("b", [1, 1024, 16600])
def test_generic_runner_on_card_matches_interpreter(device, b):
    """The generic op-group runner on the card: its outputs stay on the
    card, equal bit for bit to ``DaisProgram.run``, and it launches no B4."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import compile_program

    prog = _jsc_program(device)
    eng = compile_program(prog, device=device, engine="groups")
    codes = _in_range(prog, b, seed=b)
    before = ops.launch_counts()["lut_serve"]
    out = eng.run(codes)
    torch.cuda.synchronize()
    assert eng.path == "generic" and out.device.type == "cuda"
    assert ops.launch_counts()["lut_serve"] == before
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes))


@pytest.mark.parametrize("engine", ["pallas", "fused", "groups"])
def test_run_float_on_card_equals_the_interpreter(device, engine):
    """``ServeEngine.run_float`` on the card: floats off the input grid and
    on its ties, rounded onto it, served, scaled back; equal to
    ``DaisProgram.run_float``, through one B4 launch on the pallas path."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import compile_program, input_code_bounds

    prog = _jsc_program(device)
    eng = compile_program(prog, device=device, engine=engine)
    lo, _hi = input_code_bounds(prog)
    codes = _in_range(prog, 1024, seed=5)
    off = np.random.default_rng(6).choice([-0.5, -0.3, 0.0, 0.25, 0.45], codes.shape)
    off = np.where((off == -0.5) & (codes == lo), 0.0, off)
    x = (codes + off) * np.exp2(-np.asarray(prog.input_f, np.float64))
    before = ops.launch_counts()["lut_serve"]
    got = eng.run_float(x)
    assert ops.launch_counts()["lut_serve"] - before == (1 if engine == "pallas" else 0)
    np.testing.assert_array_equal(got, prog.run_float(x))


@pytest.mark.parametrize("arch", ["olmo_1b", "phi35_moe", "internvl2_26b", "zamba2_12b",
                                  "rwkv6_16b", "whisper_base"])
def test_build_model_defaults_to_the_card(device, arch):
    """With no ``device`` each family's model is built on the card."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    model = build_model(get_smoke(arch), generator=torch.Generator().manual_seed(0))
    assert model.device == torch.device("cuda", 0)
    assert {p.device for p in model.parameters()} == {torch.device("cuda", 0)}


def test_one_window_pid_serves_generic_on_card(device):
    from repro_torch.core.lower import lower
    from repro_torch.models.pid import build_pid_graph, build_pid_layers
    from repro_torch.serve.api import EngineSpec, build

    layers = build_pid_layers(device=device, generator=torch.Generator().manual_seed(0))
    prog = lower(build_pid_graph(layers, n_samples=20))
    with pytest.warns(UserWarning, match="downgraded to 'generic'"):
        built = build(prog, EngineSpec(engine="pallas", n_random=1024), device=device)
    codes = _in_range(prog, 1024, seed=2)
    out = built.engine.run(codes)
    assert out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes))


@pytest.mark.parametrize("narrow", [True, False])
def test_dce_program_through_b4_and_rtl_on_card(device, narrow):
    """A DCE'd program served through B4 in one launch a batch, gated
    against the unoptimized oracle, and attested three ways with the engine
    on the card."""
    from repro_torch.core.rtl import verify_rtl
    from repro_torch.kernels import ops
    from repro_torch.serve.api import EngineSpec, build

    prog = _jsc_program(device)
    built = build(prog, EngineSpec(engine="pallas", require="pallas", optimize=True,
                                   narrow=narrow, n_random=1024), device=device)
    assert built.oracle is prog and built.engine.path == "pallas"
    codes = _in_range(prog, 16600, seed=3)
    before = ops.launch_counts()["lut_serve"]
    out = built.engine.run(codes)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lut_serve"] == before + 1
    np.testing.assert_array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes))
    att = verify_rtl(built.prog, oracle=prog, engine=built.engine, n_random=256)
    assert att["verdict"] == "bit-exact" and att["engine_path"] == "pallas"


# --------------------------------------------------------------------------- #
# the serving stack on the card: bundles, the scheduler, the tier
# --------------------------------------------------------------------------- #
def _bundle(device, tmp_path):
    from repro_torch.serve.artifact import load_artifact, save_artifact

    prog = _jsc_program(device)
    path = str(tmp_path / "jsc.npz")
    save_artifact(path, prog)
    return prog, path, load_artifact(path)


def test_b4_from_a_stored_payload_at_every_bucket(device, tmp_path):
    """B4 on a bundle's stored (int64-packed) payload lowered at int32, one
    launch a call, bit for bit its plain version at every bucket 1..64."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, run_chain,
                                                    run_chain_plain)
    from repro_torch.serve.scheduler import bucket_ladder

    prog, _path, art = _bundle(device, tmp_path)
    chain = PackedChain(art.packed, torch.int32, device)
    for b in bucket_ladder(64):
        codes = _in_range(prog, b, seed=b)
        x = torch.as_tensor(codes, device=device, dtype=torch.int32)
        before = ops.launch_counts()["lut_serve"]
        got = run_chain(chain, x)
        torch.cuda.synchronize()
        assert ops.launch_counts()["lut_serve"] == before + 1
        assert torch.equal(got, run_chain_plain(chain, x))
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.int64), prog.run(codes))


def test_micro_batcher_with_two_workers_on_b4(device, tmp_path):
    from repro_torch.kernels import ops
    from repro_torch.serve.api import EngineSpec, build
    from repro_torch.serve.scheduler import MicroBatcher, ServeConfig

    prog, path, _art = _bundle(device, tmp_path)
    engine = build(path, EngineSpec(engine="pallas", require="pallas", n_random=1024),
                   device=device).engine
    codes = _in_range(prog, 1000, seed=7)
    before = ops.launch_counts()["lut_serve"]
    with MicroBatcher(engine, ServeConfig(max_batch=64, max_delay_ms=2.0,
                                          n_workers=2)) as mb:
        out = np.stack([f.result(timeout=60) for f in mb.submit_many(codes)])
    np.testing.assert_array_equal(out.astype(np.int64), prog.run(codes))
    s = mb.stats()
    assert s.n_requests == 1000 and s.engine_path == "pallas"
    assert ops.launch_counts()["lut_serve"] - before == s.n_batches + 7   # + warm-up


def test_tier_first_calls_race_load_once_and_count_every_launch(device, tmp_path,
                                                                monkeypatch):
    """Two replicas make their first B4 call together with the library
    unloaded: one of them builds and loads it, the other waits; then 8
    threads launch B4 at once, and the counter holds every launch of both."""
    import itertools
    import threading
    import time

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops
    from repro_torch.serve.api import EngineSpec, build, tier_from_built
    from repro_torch.serve.scheduler import ServeConfig
    from repro_torch.serve.tier import TierConfig

    prog, path, _art = _bundle(device, tmp_path)
    built = build(path, EngineSpec(engine="pallas", require="pallas", verify="skip"),
                  device=device)
    loads, entered = [], set()
    real_load, real_build_all = kbuild.load, kbuild.build_all

    def recorded_load(name, bind):
        if name not in kbuild._LOADED:      # this thread found it unloaded
            entered.add(threading.get_ident())
        return real_load(name, bind)

    def slow_build_all(names):
        loads.extend(names)
        time.sleep(0.2)                     # both replicas arrive meanwhile
        return real_build_all(names)

    monkeypatch.setattr(kbuild, "_LOADED", {})
    monkeypatch.setattr(kbuild, "load", recorded_load)
    monkeypatch.setattr(kbuild, "build_all", slow_build_all)
    tier = tier_from_built({"jsc": built}, TierConfig(
        n_replicas=2, steal=False, warmup=False,
        serve=ServeConfig(max_batch=64, max_delay_ms=2.0, warmup=False)), start=False)
    turn = itertools.count()                # alternate the replicas
    monkeypatch.setattr(tier, "_route_locked", lambda: next(turn) % 2)
    codes = _in_range(prog, 128, seed=8)
    before = ops.launch_counts()["lut_serve"]
    with tier:
        futs = [tier.submit(codes[k]) for k in range(len(codes))]
        out = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_array_equal(out.astype(np.int64), prog.run(codes))
    s = tier.stats()
    assert loads == ["lut_serve"] and len(entered) == 2
    assert all(n > 0 for n in s.per_replica_batches)
    assert ops.launch_counts()["lut_serve"] - before == s.n_batches

    chain = built.engine
    x = torch.as_tensor(codes[:64], device=device, dtype=torch.int32)
    before = ops.launch_counts()["lut_serve"]
    threads = [threading.Thread(target=lambda: [chain.run(x) for _ in range(250)])
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["lut_serve"] - before == 8 * 250


def test_pareto_smoke_on_card_launches_b4_for_every_engine_call(device, tmp_path):
    """The port's Pareto launcher, ``--smoke --engine pallas --verify-rtl``,
    on the card: every snapshot gated on B4's path, β the schedule's value
    on the card, the served bundle's tier responses bit-exact, and B4's
    launches exactly the gates, warm-ups, bench rounds and tier batches."""
    from chip_smoke import pareto_b4_launches
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.kernels import ops
    from repro_torch.launch import pareto

    args = pareto.build_argparser().parse_args([
        "--smoke", "--engine", "pallas", "--verify-rtl", "--out", str(tmp_path / "p.json"),
        "--ckpt-dir", str(tmp_path / "ckpt")])
    ops.reset_launch_counts()
    payload, state = pareto.sweep(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert len(payload["points"]) == 3
    assert all(p["engine_path"] == "pallas" and p["verify"]["random"] > 0
               for p in payload["points"])
    sched = BetaSchedule(args.beta_init, args.beta_final, payload["steps"])
    assert [p["beta"] for p in payload["points"]] == \
        [pareto.beta_used(sched, p["step"] - 1, device) for p in payload["points"]]
    assert state["rtl"]["verdict"] == "bit-exact" and state["rtl"]["engine_path"] == "pallas"
    assert counts["lut_serve"] == pareto_b4_launches(payload, state)
    assert counts["fake_quant"] > 0 and counts["lut_dense"] == counts["lut_dense_bwd"] == 0
    assert any(c[4] for c in state["chunks"])            # graph chunks were captured


def test_nla_step_on_card_matches_cpu(device):
    """One CE step's gradients of the NLA stack at B = 4096 on the card
    within 1e-4 of each tensor's largest against the CPU's."""
    import chip_smoke

    old = chip_smoke.NLA_BATCH
    chip_smoke.NLA_BATCH = 4096
    try:
        _layers, _batch, worst, (ce_card, ce_cpu) = chip_smoke.pareto_nla_grads(device)
    finally:
        chip_smoke.NLA_BATCH = old
    assert worst <= chip_smoke.NLA_GRAD_RTOL
    assert ce_card == pytest.approx(ce_cpu, rel=1e-5)


# ------------------------------------------------------------ the LM zoo
@pytest.mark.parametrize("arch", ["olmo_1b", "phi35_moe", "internvl2_26b"])
def test_lm_smoke_step_on_card_matches_cpu(device, arch):
    """One objective and gradient of a decoder smoke config in float32 on
    the card against the CPU, then one Adam step each
    (``chip_smoke.lm_card_vs_cpu``: loss within 1e-5, gradients within 1e-3
    of their largest, flipped codes bounded, parameters within 2·lr)."""
    import dataclasses

    import chip_smoke
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import TrainHParams

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    r = chip_smoke.lm_card_vs_cpu(
        model, lambda dev: chip_smoke.lm_batch_on(model, 32, 2, 0, 0, dev),
        TrainHParams(adam=AdamConfig(lr=3e-4)), arch)
    assert r["dp"] <= 6e-4


def test_lm_glu_launches_b1_five_times(device):
    """An HGQ GLU forward on the card launches B1 five times (gate w, gate
    x, up w, down w, down h), and a train step of the smoke OLMo with
    per-layer remat ten times a layer."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import TrainHParams, init_state, make_train_step

    cfg = get_smoke("olmo_1b")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    step, _ = make_train_step(model, TrainHParams())
    _, opt = init_state(model)
    batch = {k: torch.randint(1, 50, (2, 32), device=device, dtype=torch.int32)
             for k in ("tokens", "labels")}
    before = ops.launch_counts()["fake_quant"]
    step(opt, batch)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fake_quant"] - before == 10 * cfg.n_layers
    before = ops.launch_counts()["fake_quant"]
    with torch.no_grad():
        model.prefill({"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    assert ops.launch_counts()["fake_quant"] - before == 5 * cfg.n_layers


def test_lm_graph_chunks_equal_eager(device):
    """The LM step in CUDA-graph chunks of 3 against eager chunks from the
    same start: parameters, Adam state and every metric bit for bit."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import run_chunked
    from repro_torch.train.steps import TrainHParams, init_state, make_train_step

    out = {}
    for mode in ("eager", "graph"):
        model = build_model(get_smoke("qwen15_05b"), device=device,
                            generator=torch.Generator(device=device).manual_seed(2))
        step, _ = make_train_step(model, TrainHParams())
        params, opt = init_state(model)
        rows = []
        _, opt, _ = run_chunked(step, params, opt, lambda s: lm_batch(0, s, 2, 32, 256), 0, 7,
                                chunk_steps=3, mode=mode, on_chunk=lambda r: rows.append(
                                    {k: v.copy() for k, v in r.metrics.items()}))
        out[mode] = ({k: p.detach().clone() for k, p in model.flat_params().items()},
                     {mv: {k: t.clone() for k, t in opt[mv].items()} for mv in ("m", "v")},
                     rows)
    (pe, oe, me), (pg, og, mg) = out["eager"], out["graph"]
    for k in pe:
        assert torch.equal(pe[k], pg[k]), k
    for mv in ("m", "v"):
        for k in oe[mv]:
            assert torch.equal(oe[mv][k], og[mv][k]), (mv, k)
    for a, b in zip(me, mg):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_lm_decode_writes_the_cache_in_place(device):
    """A decode step on the card writes its K/V rows into the prefill's
    cache tensors (no copy) and agrees with the full forward at the
    reference test's bound."""
    import chip_smoke
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    model = build_model(get_smoke("gemma3_12b"), device=device,
                        generator=torch.Generator(device=device).manual_seed(3))
    toks = torch.randint(1, 200, (2, 20), device=device, dtype=torch.int32)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": toks}, cache_len=24)
        k = cache["k"]
        ptr = k.data_ptr()
        _, cache2 = model.decode_step(cache, toks[:, 0])
    assert cache2["k"].data_ptr() == ptr and bool(k[:, :, :, 20].abs().sum() > 0)
    assert chip_smoke.lm_prefill_decode(model, toks, 3, device) <= 0.15


# ------------------------------------------------ the rest of the LM zoo
def test_zoo_chunked_matches_scan_on_card(device):
    """The chunked SSD and WKV against their scans at the published widths
    on the card (``chip_smoke.zoo_chunked``: B = 2 x 500, three decay
    settings, outputs and states within 1e-4 of their largest)."""
    import chip_smoke

    assert chip_smoke.zoo_chunked(device) <= chip_smoke.ZOO_CHUNK_RTOL


@pytest.mark.parametrize("arch", ["zamba2_12b", "rwkv6_16b", "whisper_base"])
def test_zoo_smoke_step_on_card_matches_cpu(device, arch):
    """One objective and gradient of the smoke config in float32 on the card
    against the CPU, then one Adam step each, at phase 16's bounds."""
    import dataclasses

    import chip_smoke
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.steps import TrainHParams

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    r = chip_smoke.lm_card_vs_cpu(
        model, lambda dev: chip_smoke.lm_batch_on(model, 32, 2, 0, 0, dev),
        TrainHParams(adam=AdamConfig(lr=3e-4)), arch, **chip_smoke.ZOO_SMOKE_BOUNDS.get(arch, {}))
    assert r["dp"] <= 6e-4


@pytest.mark.parametrize("arch,per_forward", [("zamba2_12b", 10), ("rwkv6_16b", 0),
                                              ("whisper_base", 16)])
def test_zoo_b1_launches(device, arch, per_forward):
    """B1 a forward of the smoke configs: Zamba2's 2 shared-block
    applications x 5, RWKV-6 none, Whisper's 4 MLPs x 4; twice that in a
    train step (per-layer remat), the decoder's half at a decode step."""
    import chip_smoke
    from repro_torch.configs.base import get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import TrainHParams, init_state, make_train_step

    model = build_model(get_smoke(arch), device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    step, _ = make_train_step(model, TrainHParams())
    _, opt = init_state(model)
    before = ops.launch_counts()["fake_quant"]
    step(opt, chip_smoke.lm_batch_on(model, 32, 2, 0, 0, device))
    torch.cuda.synchronize()
    assert ops.launch_counts()["fake_quant"] - before == 2 * per_forward
    toks = torch.randint(1, 200, (2, 16), device=device, dtype=torch.int32)
    with torch.no_grad():
        before = ops.launch_counts()["fake_quant"]
        _, cache = model.prefill({"tokens": toks, **chip_smoke.zoo_extra(model, 2, device)},
                                 cache_len=20)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fake_quant"] - before == per_forward
        before = ops.launch_counts()["fake_quant"]
        model.decode_step(cache, toks[:, 0])
        torch.cuda.synchronize()
        want = per_forward // 2 if arch == "whisper_base" else per_forward
        assert ops.launch_counts()["fake_quant"] - before == want


def test_lm_mesh_step_equals_none(device):
    """The smoke Qwen1.5 on a one-device mesh (``make_local_mesh``, nccl)
    against ``mesh=None``: two train steps, then a prefill and greedy
    decode steps, every loss, parameter, Adam moment, logit and cache bit
    for bit, and B1 as often both ways (``chip_smoke.mesh_train`` /
    ``mesh_serve_lm``, phase 17's checks at the smoke widths)."""
    import chip_smoke
    import torch.distributed as dist
    from repro_torch.configs.base import get_smoke
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.steps import TrainHParams

    mesh = make_local_mesh("cuda")
    try:
        cfg = get_smoke("qwen15_05b")
        models = chip_smoke.mesh_models(cfg, mesh, device)
        chip_smoke.mesh_train(models, mesh, device, 2, 2, 32, TrainHParams(),
                              2 * 5 * cfg.n_layers)
        chip_smoke.mesh_serve_lm(models, mesh, device, 32, 2, 4, 5 * cfg.n_layers)
    finally:
        dist.destroy_process_group()
