"""Port parity for kernel B1's entry point: ``repro_torch.kernels.ops.fake_quant``
(on the CPU, the plain version ``ref.fake_quant_ref``) against the JAX
``repro.kernels.ops.fake_quant``, which runs the Pallas kernel in interpret
mode.  Every step is exact on a power-of-two grid, so the two must agree bit
for bit: per-tensor, per-channel, per-element and trailing-broadcast widths,
SAT and WRAP, signed and unsigned, pruned widths and odd sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import ops
from repro_torch.kernels.fake_quant import fake_quant_fused, width_period

torch.set_num_threads(2)

X_SHAPE = (37, 6, 5)                 # odd sizes: 1110 elements, not /4 or /128
MODES = {"tensor": (), "channel": (5,), "element": X_SHAPE,
         "trailing": (6, 5), "trailing-lead1": (1, 6, 5)}
CASES = [(m, o, s) for m in MODES for o in ("SAT", "WRAP") for s in (True, False)]


def _case(mode, overflow, signed):
    rng = np.random.default_rng(CASES.index((mode, overflow, signed)))
    shape = MODES[mode]
    f = rng.integers(-3, 7, shape).astype(np.float32)
    i = rng.integers(-2, 5, shape).astype(np.float32)
    if shape:
        # pruned cells: total width exactly 0 and below
        flat_f, flat_i = f.reshape(-1), i.reshape(-1)
        flat_f[0], flat_i[0] = -2.0, 1.0 - (1.0 if signed else 0.0)
        flat_f[1], flat_i[1] = -3.0, 0.0
    step = np.exp2(-np.broadcast_to(f, X_SHAPE))
    top = np.exp2(np.broadcast_to(i, X_SHAPE))
    k = rng.integers(-60, 60, X_SHAPE)
    pick = rng.integers(0, 4, X_SHAPE)
    x = np.select([pick == 0, pick == 1, pick == 2],
                  [(k + 0.5) * step,                        # half-grid ties
                   np.where(k > 0, top, -top) + (k % 3 - 1) * step / 2,  # edges
                   rng.normal(0, 4, X_SHAPE) * top],        # far outside
                  k * step)
    return x.astype(np.float32), f, i


@pytest.mark.parametrize("mode,overflow,signed", CASES)
def test_fake_quant_matches_pallas_b1(mode, overflow, signed):
    x, f, i = _case(mode, overflow, signed)
    want = np.asarray(ref_ops.fake_quant(jnp.asarray(x), jnp.asarray(f),
                                         jnp.asarray(i), signed=signed,
                                         overflow=overflow))
    got = ops.fake_quant(torch.as_tensor(x), torch.as_tensor(f),
                         torch.as_tensor(i), signed=signed, overflow=overflow)
    assert got.dtype == torch.float32 and tuple(got.shape) == X_SHAPE
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("x_shape,w_shape,period", [
    ((16600, 16, 20), (16, 20), 320),      # the JSC layer-0 quantizers
    ((16600, 16, 20), (), 1),
    ((16600, 16, 20), (20,), 20),
    ((16600, 16, 20), (1, 1, 16, 20), 320),
    ((7,), (7,), 7),
    ((7,), (1,), 1),
])
def test_width_period(x_shape, w_shape, period):
    assert width_period(x_shape, w_shape) == period


@pytest.mark.parametrize("x_shape,w_shape", [
    ((16600, 16, 20), (16, 1)),            # would need a broadcast in memory
    ((16600, 16, 20), (16,)),
    ((5,), (2, 5)),
])
def test_width_period_rejects_other_shapes(x_shape, w_shape):
    with pytest.raises(ValueError, match="trailing shape"):
        width_period(x_shape, w_shape)


def test_wrapper_rejects_unknown_device_and_mode():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fake_quant_fused(x, 2.0, 2.0)
    with pytest.raises(ValueError, match="overflow"):
        fake_quant_fused(torch.zeros(4), 2.0, 2.0, overflow="CLIP")
