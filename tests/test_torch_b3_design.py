"""Kernel B3's redesign and the port's repairs C8 and C9, held on the CPU.

* C8: the plain backward paths (``core.quant._fq_bwd``, the surrogate VJP of
  every ``FakeQuant``, and ``kernels.ref.lut_dense_bwd_ref``, the plain B3)
  build their powers of two exactly, as their forwards and kernel B3 do.
  ``torch.exp2`` is exact at every integer on the CPU, so the CPU parity
  tests cannot see the fault; here ``torch.exp2`` is made inexact at 2^-127
  the way the H100's is (ROADMAP C7), and the backward must not move.
* C9: the Adam step counter lives on the parameters' device, and beta and
  the learning rate computed from it are the reference's values.
* The kernel's per-(b, j, o) quantizer arithmetic (``csrc/lut_dense_bwd.cu``
  with ``csrc/fq.cuh``), modelled in numpy float32: one product x * 2^f for
  both round(x) and the WRAP on the integer code under its guard, and y *
  2^f_out for the output grid, bit for bit equal to the plain version's
  divisions, edge widths and values included.
* The wrapper's launch plan covers every batch row exactly once, in one
  wave where the batch allows; its checks raise on what the kernel does not
  read.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebops as ref_ebops
from repro.optim import adam as ref_adam
from repro_torch import interop
from repro_torch.core import ebops as port_ebops
from repro_torch.core import quant as port_quant
from repro_torch.core.lut_layers import LUTDense
from repro_torch.kernels import lut_dense_bwd as b3
from repro_torch.kernels.ref import fake_quant_ref, lut_dense_bwd_ref
from repro_torch.optim import adam as port_adam

torch.set_num_threads(2)

EDGE_F = (-127.0, 127.0)
EDGE_I = -127.0


def _ldexp(e):
    """Exact float32 2^e (0 below 2^-149, inf above 2^127)."""
    with np.errstate(over="ignore"):
        return np.ldexp(np.float32(1.0), np.asarray(e, np.int32)).astype(np.float32)


def _same_bits(a, b):
    """Identical bit patterns, any NaN matching any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    return np.array_equal(np.where(nan, 0, a).view(np.int32),
                          np.where(nan, 0, b).view(np.int32))


@pytest.fixture
def card_exp2(monkeypatch):
    """``torch.exp2`` as the H100 computes it at -127: one ulp off."""
    real = torch.exp2

    def exp2(e, *a, **k):
        out = real(e, *a, **k)
        return torch.where(e == -127.0, out * (1.0 + 2.0 ** -20), out)

    monkeypatch.setattr(torch, "exp2", exp2)
    assert float(torch.exp2(torch.tensor(-127.0))) != 2.0 ** -127
    return exp2


# ------------------------------------------------------------------- C8
@pytest.mark.parametrize("overflow", ["SAT", "WRAP"])
@pytest.mark.parametrize("f,i", [(127.0, -127.0), (-127.0, 127.0), (127.0, 0.0),
                                 (4.0, EDGE_I), (130.0, EDGE_I), (3.0, 2.0)])
def test_fq_bwd_uses_exact_powers_of_two(f, i, overflow, card_exp2):
    """The surrogate VJP at f = +-127 and i = -127 equals a numpy model on
    exact powers of two, with ``torch.exp2`` inexact at -127 as on the card."""
    rng = np.random.default_rng(abs(int(f)) * 7 + abs(int(i)))
    scale, top = _ldexp(-f), _ldexp(i)
    with np.errstate(over="ignore", under="ignore"):
        x = np.concatenate([rng.integers(-40, 40, 300) * scale * 0.5,
                            rng.normal(0, 1, 300) * top * 2.0,
                            rng.normal(0, 1, 300)]).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    ft, it = torch.tensor(f), torch.tensor(i)
    dx, df, di = port_quant._fq_bwd(torch.as_tensor(x), ft, it, True, overflow,
                                    torch.as_tensor(g))
    # the model: numpy float32 on exact powers of two
    ln2 = np.float32(port_quant.LOG2)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        rounded = (np.rint(x / scale) * scale).astype(np.float32)
    alive = np.float32(f) + np.float32(i) + np.float32(1.0) > 0
    np.seterr(over="ignore", invalid="ignore")
    if overflow == "SAT":
        chi, clo = rounded > top - scale, rounded < -top
        want_dx = np.where(alive & ~(chi | clo), g, 0)
        dfs = np.where(clo, 0, np.where(chi, ln2 * scale, ln2 * (x - rounded)))
        dis = np.where(clo, -ln2 * top, np.where(chi, ln2 * top, 0))
    else:
        want_dx = np.where(alive, g, 0)
        dfs, dis = ln2 * (x - rounded), np.zeros_like(x)
    with np.errstate(invalid="ignore"):
        want_df = np.where(alive, dfs * g, 0).astype(np.float32)
        want_di = np.where(alive, dis * g, 0).astype(np.float32)
    assert _same_bits(dx.numpy(), want_dx)
    # the reductions: torch's own sum of the same terms
    assert _same_bits(df.numpy(), torch.as_tensor(want_df).sum().numpy())
    assert _same_bits(di.numpy(), torch.as_tensor(want_di).sum().numpy())


def test_plain_b3_at_edge_widths_ignores_an_inexact_exp2(monkeypatch):
    """``lut_dense_bwd_ref`` on one-cell inputs at f = +-127, i = -127
    (``chip_smoke.b3_edge_args``): the same bits with ``torch.exp2`` exact
    and with it one ulp off at -127, as on the card."""
    from chip_smoke import b3_edge_args

    cases = b3_edge_args(np.random.default_rng(11), 257, torch.device("cpu"))
    exact = [lut_dense_bwd_ref(x, *args, g) for _, x, args, g in cases]
    real = torch.exp2
    monkeypatch.setattr(torch, "exp2", lambda e, *a, **k: torch.where(
        e == -127.0, real(e, *a, **k) * (1.0 + 2.0 ** -20), real(e, *a, **k)))
    for (label, x, args, g), want in zip(cases, exact):
        got = lut_dense_bwd_ref(x, *args, g)
        for a, b in zip(got, want):
            assert _same_bits(a.numpy(), b.numpy()), label
        assert all(bool(torch.isfinite(t).all()) for t in got), label


@pytest.mark.parametrize("e", [-127.0, 127.0, -126.0, -149.0, -150.0, 128.0])
def test_pow2_at_the_backward_edge_widths(e):
    with np.errstate(over="ignore"):
        want = np.float32(2.0 ** e) if e >= -149 else np.float32(0.0)
    got = port_quant.pow2(torch.tensor([e, -e]))
    assert _same_bits(got.numpy(), np.asarray([want, _ldexp(-e)]))


# ------------------------------------------------------------------- C9
def test_adam_step_counter_lives_on_the_parameters_device():
    params = {"w": torch.zeros(3, device="meta"), "b": torch.zeros(2, device="meta")}
    opt = port_adam.adam_init(params)
    assert opt["step"].device.type == "meta" and opt["step"].dtype == torch.int32
    assert port_adam.adam_init({"w": torch.zeros(2)})["step"].device.type == "cpu"


def test_opt_state_from_numpy_puts_the_step_beside_the_parameters():
    layers = [LUTDense(3, 2, hidden=2, generator=torch.Generator().manual_seed(0),
                       device="cpu").to("meta")]
    d = {"m": {"l0": {}}, "v": {"l0": {}}, "step": np.int32(5)}
    from repro_torch.interop import _entries

    for key, sub, t in _entries(layers[0]):
        for mv in ("m", "v"):
            z = np.zeros(tuple(t.shape), np.float32)
            if sub:
                d[mv]["l0"].setdefault(key, {})[sub] = z
            else:
                d[mv]["l0"][key] = z
    opt = interop.opt_state_from_numpy(layers, d)
    assert opt["step"].device.type == "meta" and opt["step"].dtype == torch.int32
    assert all(v.device.type == "meta" for v in opt["m"].values())


def test_beta_and_lr_per_step_are_the_references_on_the_cpu():
    """The train path's schedules (chip_smoke.train_setup) step by step on a
    counter from ``adam_init``: float32, on the counter's device, and the
    reference's values."""
    steps = 200
    beta = port_ebops.BetaSchedule(5e-7, 1e-4, steps)
    rbeta = ref_ebops.BetaSchedule(5e-7, 1e-4, steps)
    sched = port_adam.cosine_restarts(3e-3, first_period=steps // 2, warmup=30)
    rsched = ref_adam.cosine_restarts(3e-3, first_period=steps // 2, warmup=30)
    step = port_adam.adam_init({"w": torch.zeros(2)})["step"]
    for _ in range(steps + 5):
        b, lr = beta(step), sched(step + 1)
        assert b.dtype == lr.dtype == torch.float32
        assert b.device == lr.device == step.device
        k = int(step)
        np.testing.assert_allclose(float(b), float(rbeta(jnp.int32(k))), rtol=2e-6)
        # lr near the end of a cosine cycle is 0.5 * (1 + cos) with cos near
        # -1: the two CPUs' cos ulps cancel up, so lr holds to 1e-6 of its peak
        np.testing.assert_allclose(float(lr), float(rsched(jnp.int32(k + 1))), rtol=1e-6,
                                   atol=1e-6 * 3e-3)
        # and bit for bit what the port computed with CPU-made constants
        assert _same_bits(b.numpy(), _beta_cpu_constants(beta, step).numpy())
        assert _same_bits(lr.numpy(), _lr_cpu_constants(step + 1, 3e-3, steps // 2, 30).numpy())
        step = step + 1


def _beta_cpu_constants(s, step):
    b0 = torch.tensor(s.beta_init, dtype=torch.float32)
    b1 = torch.tensor(s.beta_final, dtype=torch.float32)
    t = torch.clamp(step.to(torch.float32) / max(s.total_steps - 1, 1), 0.0, 1.0)
    return torch.exp((1.0 - t) * torch.log(b0) + t * torch.log(b1))


def _lr_cpu_constants(step, base_lr, first_period, warmup, t_mult=2, min_frac=0.02):
    import math

    two = torch.as_tensor(t_mult, dtype=torch.float32)
    sf = step.to(torch.float32)
    s = torch.clamp(sf - warmup, min=0.0)
    cyc = torch.floor(torch.log2(1.0 + s * (t_mult - 1) / first_period) / torch.log2(two))
    start = first_period * (torch.pow(two, cyc) - 1) / (t_mult - 1)
    frac = (s - start) / (first_period * torch.pow(two, cyc))
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
    return base_lr * (min_frac + (1 - min_frac) * cos) * torch.clamp(sf / warmup, 0.0, 1.0)


def test_adam_update_makes_its_scalars_on_the_step_device():
    """Every scalar of an update (lr, bias corrections) is made where the
    counter is: on a meta counter and meta parameters nothing reaches the CPU."""
    p = {"w": torch.zeros(3, device="meta")}
    opt = port_adam.adam_init(p)
    sched = port_adam.cosine_restarts(3e-3, first_period=10, warmup=3)
    new_p, new_opt, m = port_adam.adam_update(p, {"w": torch.ones(3, device="meta")},
                                              opt, port_adam.AdamConfig(), sched)
    assert new_opt["step"].device.type == "meta" and m["lr"].device.type == "meta"
    assert new_p["w"].device.type == "meta"
    assert port_ebops.BetaSchedule(5e-7, 1e-4, 10)(new_opt["step"]).device.type == "meta"


# ------------------------------------------- B3's quantizer arithmetic (c)
def _kernel_quantizers(x, f_in, i_in, y, f_out):
    """What B3 computes per (b, j, o) for round(x), WRAP(x) and round(y),
    and where it takes its fast path; the plain version elsewhere."""
    x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
    f_in, i_in, f_out = (np.broadcast_to(np.float32(a), x.shape) for a in (f_in, i_in, f_out))
    plain_r_in, plain_xq, plain_r_out = _plain_quantizers(x, f_in, i_in, y, f_out)
    integral = ((np.abs(f_in) <= 126) & (np.abs(i_in) <= 126) & (f_in == np.trunc(f_in))
                & (i_in == np.trunc(i_in)))
    fi, ii = np.where(integral, f_in, 0), np.where(integral, i_in, 0)
    live = (i_in + f_in) + np.float32(1.0) > 0
    bits = (fi + ii + 1).astype(np.int64)
    fast = integral & live & (bits <= 24) & (fi >= -103)
    with np.errstate(over="ignore", invalid="ignore"):
        c = np.rint(x * _ldexp(fi))                  # the one product
        r_in = c * _ldexp(-fi)
    wb = np.where(fast, bits, 1)
    lo_c = -(np.int64(1) << (wb - 1))
    guard = fast & (np.abs(c) <= 2.0 ** 24 + lo_c)
    ci = np.where(guard, c, 0).astype(np.int64)
    code = lo_c + ((ci - lo_c) & ((np.int64(1) << wb) - 1))
    xq = (code.astype(np.float32) * _ldexp(-fi)).astype(np.float32)
    xq = np.where(live, np.where(guard, xq, plain_xq), np.float32(0.0))
    r_in = np.where(fast, r_in, plain_r_in)
    fast_o = (np.abs(f_out) <= 126) & (f_out == np.trunc(f_out))
    fo = np.where(fast_o, f_out, 0)
    with np.errstate(over="ignore", invalid="ignore"):
        r_out = np.rint(y * _ldexp(fo)) * _ldexp(-fo)
    r_out = np.where(fast_o, r_out, plain_r_out)
    return r_in, xq, r_out, live, guard, fast_o


def _plain_quantizers(x, f_in, i_in, y, f_out):
    """round(x), WRAP(x) and round(y) as ``lut_dense_bwd_ref`` forms them."""
    t = lambda a: torch.as_tensor(np.array(a, np.float32))
    scale_i, scale_o = port_quant.pow2(-t(f_in)), port_quant.pow2(-t(f_out))
    r_in = torch.round(t(x) / scale_i) * scale_i
    xq = fake_quant_ref(t(x), t(f_in), t(i_in), True, "WRAP")
    r_out = torch.round(t(y) / scale_o) * scale_o
    return r_in.numpy(), xq.numpy(), r_out.numpy()


B3_IN_WIDTHS = ((-127, 127), (-126, 126), (-104, 110), (-103, 110), (-8, 9), (0, 3),
                (4, 2), (4, 19), (4, 20), (4, 21), (12, 11), (127, -127), (126, -120),
                (127, -121), (3, 126), (3, 127), (-2, -3), (5, -6), (2.5, 1))
B3_OUT_F = (-127, -126, -8, 0, 4, 12, 126, 127, 130, 3.5)


def _values(rng, f):
    """x near the codes of grid f: ties, wrap and guard edges, huge,
    subnormal, zeros, inf and NaN."""
    f = int(np.clip(f, -126, 126))
    s = np.float64(2.0) ** -f
    k = np.concatenate([rng.integers(-2 ** 25, 2 ** 25, 200),
                        [2 ** 23, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1, -2 ** 24]])
    with np.errstate(over="ignore", under="ignore"):
        x = np.concatenate([k * s, (k + 0.5) * s, rng.normal(0, 1, 200) * 10.0 **
                            rng.integers(-45, 38, 200)]).astype(np.float32)
    special = np.float32([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45, 3.4e38])
    return np.concatenate([x, special])


@pytest.mark.parametrize("f_in,i_in", B3_IN_WIDTHS)
def test_kernel_quantizer_arithmetic_equals_the_plain_version(f_in, i_in):
    rng = np.random.default_rng(int(abs(f_in) * 131 + abs(i_in)))
    x = _values(rng, f_in)
    fast_in = 0
    for f_out in B3_OUT_F:
        y = _values(rng, f_out)[:len(x)]
        r_in, xq, r_out, live, guard, fast_o = _kernel_quantizers(x, f_in, i_in, y, f_out)
        p_r_in, p_xq, p_r_out = _plain_quantizers(x, np.full_like(x, f_in),
                                                  np.full_like(x, i_in), y,
                                                  np.full_like(x, f_out))
        assert _same_bits(xq, p_xq), (f_in, i_in)
        # round(x) enters only where the cell is alive
        assert _same_bits(np.where(live, r_in, 0), np.where(live, p_r_in, 0)), (f_in, i_in)
        assert _same_bits(r_out, p_r_out), f_out
        assert fast_o.all() == (abs(f_out) <= 126 and f_out == int(f_out))
        fast_in += int(guard.sum())
    # the shortcut is taken wherever the guard allows, not vacuously
    w = f_in + i_in + 1
    if (f_in == int(f_in) and abs(f_in) <= 126 and abs(i_in) <= 126 and 1 <= w <= 24
            and f_in >= -103):
        assert fast_in > len(x)


# -------------------------------------------------------- launch plan (d)
@pytest.mark.parametrize("batch", [0, 1, 1023, 4099, 16600])
@pytest.mark.parametrize("sm_count", [1, 132])
@pytest.mark.parametrize("c_in,c_out", [(16, 20), (20, 5), (1, 1), (300, 7)])
@pytest.mark.parametrize("blocks_per_sm", [1, 2])
def test_launch_plan_covers_every_row_once(batch, sm_count, c_in, c_out, blocks_per_sm):
    plan = b3.launch_plan(batch, c_in, c_out, 8, sm_count, blocks_per_sm)
    s, rows = plan.n_split, plan.split_rows
    assert s >= 1 and 0 <= rows <= 2048
    seen = np.zeros(batch, np.int64)
    for k in range(s):
        lo, hi = k * rows, min((k + 1) * rows, batch)
        assert hi > lo or batch == 0                  # no split is empty
        seen[lo:hi] += 1
    assert (seen == 1).all()
    slots = sm_count * blocks_per_sm
    # one wave, unless one split per channel already overfills the card or
    # the shared-memory cap on rows forces more splits
    assert s * c_in <= max(slots, c_in) or s == -(-batch // 2048)
    if batch >= 32 * (slots // c_in) and slots >= c_in:
        assert s * c_in > slots - c_in                # the wave is full
    assert plan.n_partial == s * c_in * (3 * 8 + 4) * c_out
    assert plan.n_tickets == c_in


def test_launch_plan_at_the_path_shape_on_an_h100():
    # 132 SMs, two resident blocks each: 13 x 20 = 260 of 264 slots
    assert b3.launch_plan(16600, 20, 5, 8, 132, 2)[:2] == (13, 1277)
    assert b3.launch_plan(16600, 16, 20, 8, 132, 2)[:2] == (16, 1038)


def test_wrapper_checks_raise_on_what_the_kernel_does_not_read():
    layer = LUTDense(4, 3, hidden=2, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    args = [a.detach().clone() for a in layer.kernel_args()]
    x, g = torch.zeros(9, 4), torch.zeros(9, 3)
    b3._check((x, *args, g))                          # accepted
    bad = {
        "x must be \\(B, C_in\\)": (torch.zeros(9), *args, g),
        "w0 must be": (torch.zeros(9, 5), *args, g),
        "g must be": (x, *args, torch.zeros(9, 4)),
        "w_out must be": (x, *args[:2], args[2][:, :1], *args[3:], g),
        "f_in must be contiguous float32": (x, *args[:4], args[4].double(), *args[5:], g),
        "b0 must be contiguous float32": (x, args[0], args[1].transpose(0, 1).contiguous()
                                          .transpose(0, 1), *args[2:], g),
        "i_out must be contiguous float32": (x, *args[:7], args[7].to("meta"), g),
    }
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            b3._check(call)
    with pytest.raises(ValueError, match="no kernel for device"):
        b3.lut_dense_bwd_fused(x.to("meta"), *args, g)
