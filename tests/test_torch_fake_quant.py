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
from repro_torch.kernels.fake_quant import fake_quant_fused, width_period, x_layout
from repro_torch.kernels.ref import fake_quant_ref

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


# --------------------------------------------------------------------------- #
# The algebra kernel B1 rests on (csrc/fake_quant.cu), modelled in numpy
# float32 and held against the plain version bit for bit.

def _np_pow2(e):
    return np.ldexp(np.float32(1.0), np.asarray(e, np.int32)).astype(np.float32)


def _plain(x, f, i, signed, overflow):
    # widths at x's full size, so every call takes the same CPU code path:
    # PyTorch's CPU kernels order two zeros differently in their broadcast
    # and dense loops (ROADMAP C5)
    x = np.asarray(x, np.float32)
    f, i = (np.broadcast_to(np.asarray(a, np.float32), x.shape) for a in (f, i))
    x, f, i = (torch.as_tensor(np.array(a)) for a in (x, f, i))
    return fake_quant_ref(x, f, i, signed, overflow).numpy()


def _wrap_guard(f, i, signed, c):
    """Where B1 takes the integer wrap: 1 <= w <= 24, -103 <= f <= 126,
    |i| <= 126, integer widths, and |c| <= 2^24 - |lo_c|."""
    w = f + i + (1 if signed else 0)
    lo_c = np.where(signed, -np.exp2(np.clip(w, 1, 24) - 1), 0.0)
    widths_ok = ((w >= 1) & (w <= 24) & (f >= -103) & (f <= 126) & (np.abs(i) <= 126)
                 & (f == np.trunc(f)) & (i == np.trunc(i)))
    return widths_ok & (np.abs(c) <= 2.0 ** 24 + lo_c)


def _integer_wrap(x, f, i, signed):
    """``lo_c + ((c - lo_c) & (2^w - 1))`` times 2^-f, c = rint(x * 2^f),
    computed wherever it is defined (no guard)."""
    w = (f + i + (1 if signed else 0)).astype(np.int64)
    with np.errstate(over="ignore", invalid="ignore"):
        c = np.rint(x * _np_pow2(f))
    ok = np.isfinite(c) & (np.abs(c) < 2.0 ** 62) & (w >= 1) & (w <= 60)
    ci = np.where(ok, c, 0).astype(np.int64)
    wb = np.where(ok, w, 1)
    lo_c = -(np.int64(1) << (wb - 1)) if signed else np.zeros_like(wb)
    code = lo_c + ((ci - lo_c) & ((np.int64(1) << wb) - 1))
    return (code.astype(np.float32) * _np_pow2(-f)).astype(np.float32), c


def _design(x, f, i, signed, overflow):
    """B1's per-element arithmetic: the x * 2^f product (|f| <= 126, integer
    widths), the integer wrap under its guard, the SAT clamp, and the plain
    version wherever the kernel falls back to fq::quantize."""
    x = np.asarray(x, np.float32)
    f = np.broadcast_to(np.asarray(f, np.float32), x.shape)
    i = np.broadcast_to(np.asarray(i, np.float32), x.shape)
    plain = _plain(x, f, i, signed, overflow)
    integral = (np.abs(f) <= 126) & (np.abs(i) <= 126) & (f == np.trunc(f)) & (i == np.trunc(i))
    fi, ii = np.where(integral, f, 0), np.where(integral, i, 0)
    live = (i + f + np.float32(1.0 if signed else 0.0)) > 0
    with np.errstate(over="ignore", invalid="ignore"):
        c = np.rint(x * _np_pow2(fi))
    if overflow == "SAT":
        scale, top = _np_pow2(-fi), _np_pow2(ii)
        lo = -top if signed else np.zeros_like(top)
        with np.errstate(over="ignore", invalid="ignore"):
            q = torch.as_tensor(c * scale)
        q = torch.where(torch.isnan(q), q, torch.minimum(
            torch.maximum(q, torch.as_tensor(lo)), torch.as_tensor(top - scale))).numpy()
        fast = integral
    else:
        q, _ = _integer_wrap(x, fi, ii, signed)
        with np.errstate(invalid="ignore"):
            fast = integral & _wrap_guard(fi, ii, signed, c)
    out = np.where(fast, q, plain)
    return np.where(live, out, np.float32(0.0)).astype(np.float32), fast & live


def _same_bits(a, b, zeros_by_value=False):
    """Identical bit patterns, except that NaNs match any NaN (the CPU keeps
    payloads that the card does not) and, with ``zeros_by_value``, +0
    matches -0: PyTorch's CPU minimum/maximum order two zeros by where the
    element falls in its vector loop (ROADMAP C5), so the SAT clamp, which
    the model shares with the plain version, may differ there in sign."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    a, b = np.where(nan, 0, a), np.where(nan, 0, b)
    if zeros_by_value:
        a, b = a + np.float32(0.0), b + np.float32(0.0)       # -0 + 0 = +0
    return np.array_equal(a.view(np.int32), b.view(np.int32))


def _probe_x(f, rng, n=4000):
    """Edge and random x for widths (f, ...): ties, huge, subnormal, zeros."""
    s = np.float64(2.0) ** -np.float64(f)
    k = rng.integers(-2 ** 26, 2 ** 26, n).astype(np.float64)
    with np.errstate(over="ignore", under="ignore"):
        x = np.concatenate([k * s, (k + 0.5) * s, rng.normal(0, 1, n) * s * 1e3,
                            rng.normal(0, 1, n) * 10.0 ** rng.integers(-45, 38, n)])
        x = x.astype(np.float32)
    special = np.float32([np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-40, 3.4e38,
                          -3.4e38, 1.1754944e-38])
    return np.concatenate([x, special])


@pytest.mark.parametrize("f", [-126, -125, -103, -64, -8, -3, -1, 0, 1, 3, 8, 12,
                               64, 100, 125, 126])
def test_multiply_by_2_pow_f_equals_divide_by_2_pow_minus_f(f):
    rng = np.random.default_rng(1000 + f)
    x = _probe_x(f, rng)
    with np.errstate(over="ignore", under="ignore"):
        prod = x * _np_pow2(f)
        quot = x / _np_pow2(-f)
    assert _same_bits(prod, quot)
    # and so B1's SAT on the product equals the plain version (x / 2^-f)
    for signed in (True, False):
        i = np.float32(np.clip(5 - f, -126, 126))
        got, fast = _design(x, np.float32(f), i, signed, "SAT")
        assert fast.any() == (f + i + signed > 0)          # else pruned
        assert _same_bits(got, _plain(x, np.float32(f), i, signed, "SAT"),
                          zeros_by_value=True)


def _wrap_codes(w, signed):
    """Codes around every wrap boundary near the range and at the guard."""
    lo_c = -(2 ** (w - 1)) if signed else 0
    near = [lo_c + k * 2 ** w + d for k in range(-3, 4) for d in range(-2, 3)]
    g = 2 ** 24 + lo_c
    guard = [s * (e + d) for s in (1, -1) for e in (g, 2 ** 23, 2 ** 24)
             for d in (-2, -1, 0, 1, 2)]
    c = np.asarray(near + guard, np.float64)
    return np.concatenate([c, c + 0.5, c - 0.5])


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("f", list(range(-3, 9)))
def test_integer_wrap_equals_floor_mod(f, signed):
    for i in range(-2, 9):
        w = f + i + (1 if signed else 0)
        if w < 1:
            continue
        x = (_wrap_codes(w, signed) * 2.0 ** -f).astype(np.float32)
        fv, iv = np.float32(f), np.float32(i)
        q, c = _integer_wrap(x, fv, iv, signed)
        guard = _wrap_guard(fv, iv, signed, c)
        assert guard.sum() > len(x) // 2, (f, i)
        want = _plain(x, fv, iv, signed, "WRAP")
        assert _same_bits(q[guard], want[guard]), (f, i)
        got, _ = _design(x, fv, iv, signed, "WRAP")
        assert _same_bits(got, want), (f, i)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("f,w", [(4, 23), (4, 24), (-103, 23), (-103, 8), (126, 24),
                                 (126, 1)])
def test_integer_wrap_at_the_guard_edge(f, w, signed):
    i = w - f - (1 if signed else 0)
    fv, iv = np.float32(f), np.float32(i)
    with np.errstate(over="ignore"):                    # codes past 2^128 -> inf
        x = (_wrap_codes(w, signed) * 2.0 ** -f).astype(np.float32)
    q, c = _integer_wrap(x, fv, iv, signed)
    guard = _wrap_guard(fv, iv, signed, c)
    want = _plain(x, fv, iv, signed, "WRAP")
    assert guard.any() and not guard.all()
    assert _same_bits(q[guard], want[guard])
    assert _same_bits(_design(x, fv, iv, signed, "WRAP")[0], want)


def test_integer_wrap_past_the_guard_would_differ():
    """The guard is not slack: one code past |c| = 2^24 - |lo_c| (w = 24),
    or at w = 25, the plain version's float steps round and the integer
    formula gives another value."""
    misses = 0
    for f, w, signed in ((4, 24, True), (4, 25, True), (4, 25, False), (0, 25, True)):
        i = w - f - (1 if signed else 0)
        x = (_wrap_codes(w, signed) * 2.0 ** -f).astype(np.float32)
        q, c = _integer_wrap(x, np.float32(f), np.float32(i), signed)
        want = _plain(x, np.float32(f), np.float32(i), signed, "WRAP")
        misses += int((q.view(np.int32) != want.view(np.int32)).sum())
    assert misses > 0


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("overflow", ["SAT", "WRAP"])
def test_design_matches_plain_on_edge_values_and_widths(signed, overflow):
    from chip_smoke import B1_EDGE_WIDTHS, b1_edge_values

    x = b1_edge_values(B1_EDGE_WIDTHS, signed)
    pairs = np.asarray(B1_EDGE_WIDTHS, np.float32)
    got, fast = _design(x, pairs[:, 0], pairs[:, 1], signed, overflow)
    assert fast.any() and not fast.all()
    assert _same_bits(got, _plain(x, pairs[:, 0], pairs[:, 1], signed, overflow),
                      zeros_by_value=overflow == "SAT")


# --------------------------------------------------------------------------- #
# The wrapper's layouts: contiguous and last-axis-expanded x are read in
# place, anything else is copied by core.quant._fq_forward.

def _layouts():
    src = torch.arange(6 * 4, dtype=torch.float32).reshape(6, 4)
    return {
        "contiguous": (src, "self", 1),
        "expand last": (src[:, :, None].expand(6, 4, 5), "source", 5),
        "expand last of 1-D": (src[0][:, None].expand(4, 3), "source", 3),
        "expand last, size 1": (src[:, :, None], "self", 1),
        "expand a scalar": (torch.tensor(2.5).expand(7), "source", 7),
        "expand middle": (src[:, None, :].expand(6, 5, 4), None, None),
        "expand two axes": (src[0, 0].expand(6, 5), None, None),
        "transposed": (src.T, None, None),
        "strided rows": (src[::2], None, None),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_x_layout(name):
    x, kind, expand = _layouts()[name]
    got = x_layout(x)
    if kind is None:
        assert got is None
        return
    src, e = got
    assert e == expand and src.is_contiguous()
    assert src.data_ptr() == x.data_ptr()
    if kind == "self":
        assert src is x
    # element k of the contiguous x reads source[k // expand]
    torch.testing.assert_close(src.reshape(-1).repeat_interleave(e), x.reshape(-1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(_layouts()))
def test_fq_forward_copies_only_what_b1_cannot_read(name, monkeypatch):
    from repro_torch.core import quant
    from repro_torch.kernels import fake_quant as fq_mod

    x, kind, _ = _layouts()[name]
    seen = []
    real = fq_mod.fake_quant_fused

    def spy(xx, *a, **k):
        seen.append(xx)
        return real(xx, *a, **k)

    monkeypatch.setattr(fq_mod, "fake_quant_fused", spy)
    out = quant._fq_forward(x, torch.tensor(2.0), torch.tensor(3.0), True, "WRAP")
    (passed,) = seen
    if kind is None:
        assert passed.is_contiguous() and passed.data_ptr() != x.data_ptr()
    else:
        assert passed is x
    want = fake_quant_ref(x.contiguous(), torch.tensor(2.0), torch.tensor(3.0), True,
                          "WRAP")
    assert _same_bits(out.numpy(), want.numpy())


@pytest.mark.parametrize("overflow", ["SAT", "WRAP"])
@pytest.mark.parametrize("wshape", [(), (20,), (16, 20)])
def test_ops_fake_quant_on_an_expand_view_equals_the_copy(overflow, wshape):
    rng = np.random.default_rng(len(wshape) + 7 * (overflow == "WRAP"))
    src = torch.as_tensor(rng.normal(0, 6, (333, 16)), dtype=torch.float32)
    f = torch.as_tensor(rng.integers(-3, 7, wshape), dtype=torch.float32)
    i = torch.as_tensor(rng.integers(-2, 5, wshape), dtype=torch.float32)
    view = src[:, :, None].expand(333, 16, 20)
    got = ops.fake_quant(view, f, i, signed=True, overflow=overflow)
    want = ops.fake_quant(view.contiguous(), f, i, signed=True, overflow=overflow)
    assert got.shape == (333, 16, 20)
    assert _same_bits(got.numpy(), want.numpy())


@pytest.mark.parametrize("train", [True, False])
def test_lut_dense_forward_unchanged_by_the_in_place_read(train, monkeypatch):
    """LUTDense's einsum forward (and its train gradients) with the input
    quantizer reading the expand view in place equal the forward that copies
    it first, as before."""
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import fake_quant as fq_mod

    layer = LUTDense(16, 20, hidden=8, use_batchnorm=True,
                     generator=torch.Generator().manual_seed(5), device="cpu")
    layer.train(train)
    x = torch.as_tensor(np.random.default_rng(5).normal(0, 3, (64, 16)),
                        dtype=torch.float32)

    def run():
        layer.zero_grad()
        out, _ = layer(x, fused=False)
        if train:
            out.square().sum().backward()
        return out.detach().clone(), {n: (p.grad.clone() if p.grad is not None else None)
                                      for n, p in layer.named_parameters()}

    out, grads = run()
    monkeypatch.setattr(fq_mod, "x_layout",
                        lambda t: (t, 1) if t.is_contiguous() else None)
    out_copy, grads_copy = run()
    assert _same_bits(out.numpy(), out_copy.numpy())
    for name, g in grads.items():
        assert (g is None) == (grads_copy[name] is None), name
        if g is not None:
            assert _same_bits(g.numpy(), grads_copy[name].numpy()), name


@pytest.mark.parametrize("lo,hi", [(-160, -127), (-126, 127), (128, 140)])
def test_pow2_is_exact_at_integers(lo, hi):
    from repro_torch.core.quant import pow2

    e = np.arange(lo, hi + 1)
    with np.errstate(over="ignore"):
        want = np.ldexp(np.float32(1.0), e).astype(np.float32)
    got = pow2(torch.as_tensor(e, dtype=torch.float32)).numpy()
    assert _same_bits(got, want)
    frac = torch.as_tensor(e + 0.25, dtype=torch.float32)
    assert _same_bits(pow2(frac).numpy(), torch.exp2(frac).numpy())
