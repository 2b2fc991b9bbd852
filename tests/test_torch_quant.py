"""Port parity: eval fake-quant, bit-widths, EBOPs and the integer code path
(``repro_torch.core.quant`` / ``ebops``) against ``repro.core.quant`` on the
same numpy-seeded inputs.  Fake-quant must be identical, element for element,
on half-grid ties and wrap edges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebops as ref_ebops
from repro.core import quant as ref_quant
from repro_torch.core import ebops as port_ebops
from repro_torch.core import quant as port_quant

torch.set_num_threads(2)

SHAPE = (6, 5)


def _inputs(rng, f, i):
    """Half-grid ties, values on and just beside the wrap/saturation edges,
    and random values far outside the range."""
    f = np.broadcast_to(f, SHAPE)
    i = np.broadcast_to(i, SHAPE)
    step = np.exp2(-f)
    top = np.exp2(i)
    k = rng.integers(-40, 40, (64,) + SHAPE)
    ties = (k + 0.5) * step                              # exact half steps
    edges = np.stack([top, -top, top - step, -top - step, top + step / 2,
                      -top - step / 2, 2 * top, -2 * top - step / 2])
    wide = rng.normal(0, 4, (64,) + SHAPE) * top
    return np.concatenate([ties, edges, wide]).astype(np.float32)


def _widths(rng, granularity):
    shape = {"element": SHAPE, "channel": SHAPE[-1:], "tensor": ()}[granularity]
    f = rng.integers(-3, 7, shape).astype(np.float32) + rng.uniform(-0.4, 0.4, shape)
    i = rng.integers(-2, 5, shape).astype(np.float32) + rng.uniform(-0.4, 0.4, shape)
    return f.astype(np.float32), i.astype(np.float32)


CASES = [(o, s, g) for o in ("SAT", "WRAP") for s in (True, False)
         for g in ("element", "channel", "tensor")]


@pytest.mark.parametrize("overflow,signed,granularity", CASES)
def test_fake_quant_eval_identical(overflow, signed, granularity):
    rng = np.random.default_rng(CASES.index((overflow, signed, granularity)))
    cfg = dict(granularity=granularity, signed=signed, overflow=overflow,
               min_f=-2, max_f=6, min_i=-1, max_i=4)
    f, i = _widths(rng, granularity)
    fr, ir = np.clip(np.round(f), -2, 6), np.clip(np.round(i), -1, 4)
    x = _inputs(rng, fr, ir)
    want = np.asarray(ref_quant.fake_quant(
        {"f": jnp.asarray(f), "i": jnp.asarray(i)}, jnp.asarray(x),
        ref_quant.QuantConfig(**cfg), train=False))
    got = port_quant.fake_quant(
        {"f": torch.as_tensor(f), "i": torch.as_tensor(i)}, torch.as_tensor(x),
        port_quant.QuantConfig(**cfg)).numpy()
    np.testing.assert_array_equal(got, want)
    # and the integer code path both packages share agrees with it
    codes = port_quant.quantize_to_int(x, fr, ir, signed, overflow)
    np.testing.assert_array_equal(
        port_quant.int_to_float(codes, fr).astype(np.float32), got)


@pytest.mark.parametrize("granularity", ["element", "channel", "tensor"])
def test_bitwidth_int_bits_ebops(granularity):
    rng = np.random.default_rng(7)
    f, i = _widths(rng, granularity)
    cfg = dict(granularity=granularity, min_f=-2, max_f=6, min_i=-1, max_i=4)
    qr = {"f": jnp.asarray(f), "i": jnp.asarray(i)}
    qp = {"f": torch.as_tensor(f), "i": torch.as_tensor(i)}
    rc, pc = ref_quant.QuantConfig(**cfg), port_quant.QuantConfig(**cfg)
    np.testing.assert_array_equal(port_quant.bitwidth(qp, pc).numpy(),
                                  np.asarray(ref_quant.bitwidth(qr, rc)))
    for a, b in zip(port_quant.int_bits(qp, pc), ref_quant.int_bits(qr, rc)):
        np.testing.assert_array_equal(a, b)
    m = rng.integers(-1, 9, SHAPE).astype(np.float32)
    n = rng.integers(-1, 9, SHAPE).astype(np.float32)
    want = float(ref_ebops.ebops_lut(jnp.asarray(m), jnp.asarray(n)))
    got = float(port_ebops.ebops_lut(torch.as_tensor(m), torch.as_tensor(n)))
    # float32 sums of the same terms in another order: a few ulps
    assert got == pytest.approx(want, rel=1e-6)


def test_init_quantizer_matches():
    cfg = dict(granularity="channel", init_f=3.0, init_i=1.0)
    want = ref_quant.init_quantizer(ref_quant.QuantConfig(**cfg), (4, 7))
    got = port_quant.init_quantizer(port_quant.QuantConfig(**cfg), (4, 7),
                                    device="cpu")
    for k in ("f", "i"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
