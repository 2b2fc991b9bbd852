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


# --------------------------------------------------------------- train mode
# fake_quant(train=True): the forward and the surrogate gradients for x, f
# and i against jax.grad of repro.core.quant.fake_quant.  dx is a masked copy
# of the cotangent, so it must be exact; df / di are float32 sums over the
# broadcast axes taken in another order, so they hold to rtol 1e-5.
TRAIN_CASES = [(o, s, g) for o in ("SAT", "WRAP") for s in (True, False)
               for g in ("element", "channel", "tensor")]
CLIP = dict(min_f=-2.0, max_f=6.0, min_i=-1.0, max_i=4.0)


def _train_widths(rng, granularity):
    """Continuous widths, some exactly on each clip bound (the reference's
    clip gives those half the gradient) and, per element, pruned cells."""
    f, i = _widths(rng, granularity)
    if granularity == "element":
        f[0, 0], i[0, 1] = CLIP["min_f"], CLIP["min_i"]
        f[1, 0], i[1, 1] = CLIP["max_f"], CLIP["max_i"]
        f[2, 2], i[2, 2] = -2.0, -1.0                      # width <= 0: pruned
    elif granularity == "channel":
        f[0], i[1], f[2] = CLIP["min_f"], CLIP["max_i"], CLIP["max_f"]
    else:
        f = np.float32(CLIP["max_f"])
        i = np.float32(CLIP["min_i"] + 2.0)
    return np.asarray(f, np.float32), np.asarray(i, np.float32)


def _jax_train(f, i, x, g, cfg):
    import jax

    def loss(f, i, x):
        y = ref_quant.fake_quant({"f": f, "i": i}, x, ref_quant.QuantConfig(**cfg),
                                 train=True)
        return jnp.sum(y * jnp.asarray(g)), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(f), jnp.asarray(i), jnp.asarray(x))
    return np.asarray(y), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("overflow,signed,granularity", TRAIN_CASES)
def test_fake_quant_train_gradients(overflow, signed, granularity):
    rng = np.random.default_rng(100 + TRAIN_CASES.index((overflow, signed, granularity)))
    cfg = dict(granularity=granularity, signed=signed, overflow=overflow, **CLIP)
    f, i = _train_widths(rng, granularity)
    fr = np.clip(np.round(f), CLIP["min_f"], CLIP["max_f"])
    ir = np.clip(np.round(i), CLIP["min_i"], CLIP["max_i"])
    x = _inputs(rng, fr, ir)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    want_y, (want_df, want_di, want_dx) = _jax_train(f, i, x, g, cfg)
    tf, ti, tx = (torch.tensor(a, requires_grad=True) for a in (f, i, x))
    y = port_quant.fake_quant({"f": tf, "i": ti}, tx, port_quant.QuantConfig(**cfg),
                              train=True)
    (y * torch.as_tensor(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    np.testing.assert_array_equal(tx.grad.numpy(), want_dx)
    np.testing.assert_allclose(tf.grad.numpy(), want_df, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.grad.numpy(), want_di, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lo,hi", [(-8.0, 12.0), (0.0, None), (None, 3.0)])
def test_clip_tie_gradient_is_the_references(lo, hi):
    """jax.grad of jnp.clip / jnp.maximum is 1/2 exactly on a bound, where
    torch.clamp gives 1: ste_bits and bitwidth must give the reference's."""
    import jax

    x = np.array([-9.0, -8.0, -7.5, 0.0, 0.5, 3.0, 11.0, 12.0, 13.0], np.float32)
    if hi is None:
        ref = lambda a: jnp.sum(jnp.maximum(a, lo))
    elif lo is None:
        ref = lambda a: jnp.sum(jnp.minimum(a, hi))
    else:
        ref = lambda a: jnp.sum(jnp.clip(a, lo, hi))
    want = np.asarray(jax.grad(ref)(jnp.asarray(x)))
    assert 0.5 in want
    t = torch.tensor(x, requires_grad=True)
    port_quant.clip_tie(t, lo, hi).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_round_ste_is_exact_round_with_identity_gradient():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(-50, 50, 512) + 0.5,          # ties
                        rng.normal(0, 1e6, 512), rng.normal(0, 1e-3, 512),
                        np.float32(2 ** 23) + np.arange(8) + 0.5]).astype(np.float32)
    t = torch.tensor(x, requires_grad=True)
    y = port_quant.round_ste(t)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jnp.round(jnp.asarray(x))))
    y.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones_like(x))


def test_bitwidth_and_ebops_gradients_with_pruned_cells():
    """Cells whose width is exactly 0 (and below) are pruned: Eq. (5) costs
    nothing there and both packages give them zero gradient."""
    import jax

    rng = np.random.default_rng(11)
    f, i = _train_widths(rng, "element")
    f[3, :3], i[3, :3] = np.float32(-1.0), np.float32(0.0)        # width exactly 0
    f[4, :2], i[4, :2] = np.float32(-2.0), np.float32(-1.0)       # width < 0
    f[5, 0], i[5, 0] = CLIP["min_f"], np.float32(1.0)             # 0 on the clip bound
    fo, io = (a + 1.0 for a in _train_widths(rng, "element"))
    cfg = dict(granularity="element", **CLIP)

    def ref_loss(f, i, fo, io):
        rc = ref_quant.QuantConfig(**cfg)
        return ref_ebops.ebops_lut(ref_quant.bitwidth({"f": f, "i": i}, rc),
                                   ref_quant.bitwidth({"f": fo, "i": io}, rc))

    args = (f, i, fo.astype(np.float32), io.astype(np.float32))
    want_val = float(ref_loss(*map(jnp.asarray, args)))
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    pc = port_quant.QuantConfig(**cfg)
    got = port_ebops.ebops_lut(port_quant.bitwidth({"f": ts[0], "i": ts[1]}, pc),
                               port_quant.bitwidth({"f": ts[2], "i": ts[3]}, pc))
    got.backward()
    assert float(got.detach()) == pytest.approx(want_val, rel=1e-6)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert (ts[0].grad[3, :3] == 0).all() and (ts[0].grad[4, :2] == 0).all()
