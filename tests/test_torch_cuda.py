"""Kernels B2 and B4 on the card against their plain versions.

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
