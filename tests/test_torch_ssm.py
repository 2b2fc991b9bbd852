"""``repro_torch.nn.ssm`` (Mamba2 SSD, RWKV-6 time and channel mix) against
the reference's ``repro.nn.ssm``, and its chunked recurrences against its
scans.

The same numpy parameters (the reference's init, some moved off it) and
inputs, made from seeds, go through both packages in float32.  The ports of
``tests/test_moe_ssm.py`` keep its bounds (full sequence equals stepwise
within 1e-4); the scan against the reference's scan and the chunked forms
against the scan are held to 2e-5 of the largest output or state entry:
float32 sums of up to a few hundred terms in another order (seen <= 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import ssm as jssm
from repro.nn.params import init_params as jinit
from repro_torch.nn import ssm

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
RTOL = 2e-5      # of the largest entry: float32 sums in another order


def layer0(defs, shift=None, seed=0):
    """Layer 0 of the reference's init of ``defs`` as numpy, with
    ``shift`` ({name: value}) added to some entries."""
    p = {k: np.asarray(v[0]) for k, v in jinit(defs, jax.random.PRNGKey(seed)).items()}
    for k, v in (shift or {}).items():
        p[k] = (p[k] + v).astype(np.float32)
    return p


def tp(p):
    return {k: torch.as_tensor(np.array(v)) for k, v in p.items()}


def close(got, want, rtol=RTOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, (what, err)
    return err


def mamba_case(seed, b, s, d=64, n=8, a_shift=0.0, state=True):
    rng = np.random.default_rng(seed)
    p = layer0(jssm.mamba2_defs(1, d, n), {"a_log": a_shift}, seed)
    p["dt_bias"] = rng.normal(0, 0.5, p["dt_bias"].shape).astype(np.float32)
    x = rng.normal(0, 0.5, (b, s, d)).astype(np.float32)
    di, h = 2 * d, 2 * d // ssm.MAMBA_HEAD
    st = ({"ssm": rng.normal(0, 1, (b, h, ssm.MAMBA_HEAD, n)).astype(np.float32),
           "conv": rng.normal(0, 1, (b, ssm.CONV_K - 1, di + 2 * n)).astype(np.float32)}
          if state else None)
    return p, x, st


def rwkv_case(seed, b, s, d=128, ff=256, w_shift=0.0, state=True):
    rng = np.random.default_rng(seed)
    p = layer0(jssm.rwkv6_defs(1, d, ff), {"w0": w_shift}, seed)
    p["u_bonus"] = rng.normal(0, 0.5, p["u_bonus"].shape).astype(np.float32)
    x = rng.normal(0, 0.3, (b, s, d)).astype(np.float32)
    h = d // ssm.RWKV_HEAD
    st = ({"wkv": rng.normal(0, 1, (b, h, ssm.RWKV_HEAD, ssm.RWKV_HEAD)).astype(np.float32),
           "shift_t": rng.normal(0, 1, (b, 1, d)).astype(np.float32),
           "shift_c": rng.normal(0, 1, (b, 1, d)).astype(np.float32)} if state else None)
    return p, x, st


# ------------------------------------------- ports of tests/test_moe_ssm.py
def test_mamba2_fullseq_equals_stepwise():
    """The SSD over a sequence == feeding tokens one by one with state."""
    d, n = 32, 8
    p, x, _ = mamba_case(1, 2, 6, d, n, state=False)
    zero = {"ssm": torch.zeros((2, 2 * d // ssm.MAMBA_HEAD, ssm.MAMBA_HEAD, n)),
            "conv": torch.zeros((2, ssm.CONV_K - 1, 2 * d + 2 * n))}
    y_full, _ = ssm.mamba2_apply(tp(p), torch.as_tensor(x), n, state=dict(zero))
    state, outs = dict(zero), []
    for t in range(6):
        y_t, state = ssm.mamba2_apply(tp(p), torch.as_tensor(x[:, t:t + 1]), n, state=state)
        outs.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(), atol=1e-4, rtol=1e-4)


def test_rwkv6_fullseq_equals_stepwise():
    d = 128
    p, x, _ = rwkv_case(2, 2, 5, d, state=False)
    h = d // ssm.RWKV_HEAD
    zero = {"wkv": torch.zeros((2, h, ssm.RWKV_HEAD, ssm.RWKV_HEAD)),
            "shift_t": torch.zeros((2, 1, d)), "shift_c": torch.zeros((2, 1, d))}
    y_full, _ = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x), dict(zero))
    state, outs = dict(zero), []
    for t in range(5):
        y_t, st = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x[:, t:t + 1]), state)
        state.update(st)
        outs.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(), atol=1e-4, rtol=1e-4)


def test_rwkv6_channel_mix_stepwise():
    d = 64
    p, x, _ = rwkv_case(3, 2, 4, d, 128, state=False)
    zero = {"shift_c": torch.zeros((2, 1, d))}
    y_full, _ = ssm.rwkv6_channel_mix(tp(p), torch.as_tensor(x), zero)
    state, outs = dict(zero), []
    for t in range(4):
        y_t, st = ssm.rwkv6_channel_mix(tp(p), torch.as_tensor(x[:, t:t + 1]), state)
        state.update(st)
        outs.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(), atol=1e-4, rtol=1e-4)


def test_data_dependent_decay_in_range():
    """RWKV6 'Finch': decay w_t = exp(-exp(.)) must stay in (0, 1)."""
    d = 64
    p = tp(layer0(jssm.rwkv6_defs(1, d, 128)))
    x = torch.as_tensor(np.array(jax.random.normal(KEY, (1, 8, d))))
    wlog = p["w0"] + x @ p["w_lora_a"] @ p["w_lora_b"]
    w = torch.exp(-torch.exp(wlog))
    assert bool((w > 0).all()) and bool((w < 1).all())


# ---------------------------------------------- the port against the reference
@pytest.mark.parametrize("form", ["scan", "chunked"])
@pytest.mark.parametrize("with_state", [True, False])
def test_mamba2_against_the_reference(form, with_state):
    """Output, final SSM state and conv carry (the last three steps'
    projections) against the reference's scan (S = 150: three chunks, the
    last partial; a non-zero initial state)."""
    n = 8
    p, x, st = mamba_case(4, 2, 150, n=n, state=with_state)
    yj, sj = jssm.mamba2_apply(p, jnp.asarray(x), n,
                               state=None if st is None else jax.tree.map(jnp.asarray, st))
    yt, stt = ssm.mamba2_apply(tp(p), torch.as_tensor(x), n,
                               state=None if st is None else tp(st), form=form)
    close(yt, yj, what="y")
    if with_state:
        close(stt["ssm"], sj["ssm"], what="ssm")
        close(stt["conv"], sj["conv"], what="conv")       # the last inputs' projections
    else:
        assert stt is None and sj is None


@pytest.mark.parametrize("form", ["scan", "chunked"])
@pytest.mark.parametrize("with_state", [True, False])
def test_rwkv6_time_mix_against_the_reference(form, with_state):
    """Output, final WKV state and token-shift carry (S = 75: five chunks
    of 16, the last partial)."""
    p, x, st = rwkv_case(5, 2, 75, state=with_state)
    yj, sj = jssm.rwkv6_time_mix(p, jnp.asarray(x),
                                 None if st is None else jax.tree.map(jnp.asarray, st))
    yt, stt = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x), None if st is None else tp(st),
                                 form=form)
    close(yt, yj, what="y")
    close(stt["wkv"], sj["wkv"], what="wkv")
    assert torch.equal(stt["shift_t"], torch.as_tensor(np.asarray(sj["shift_t"])))


def test_rwkv6_channel_mix_against_the_reference():
    p, x, st = rwkv_case(6, 2, 9)
    yj, sj = jssm.rwkv6_channel_mix(p, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    yt, stt = ssm.rwkv6_channel_mix(tp(p), torch.as_tensor(x), tp(st))
    close(yt, yj, what="y")
    assert torch.equal(stt["shift_c"], torch.as_tensor(np.asarray(sj["shift_c"])))


def test_causal_conv1d_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 5, 12)).astype(np.float32)
    w = rng.normal(0, 0.5, (ssm.CONV_K, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    carry = rng.normal(0, 1, (2, ssm.CONV_K - 1, 12)).astype(np.float32)
    for c in (None, carry):
        yj, cj = jssm._causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     None if c is None else jnp.asarray(c))
        yt, ct = ssm._causal_conv1d(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                                    None if c is None else torch.as_tensor(c))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6, atol=1e-7)
        assert torch.equal(ct, torch.as_tensor(np.asarray(cj)))


def test_bf16_inputs_against_the_reference():
    """bf16 activations (the models' compute dtype): the projections and
    the conv run in bf16, the recurrences in float32.  Outputs within 2e-2
    of their largest (a bf16 rounding step is 2^-8; XLA keeps float32
    inside its fusions where torch rounds after each op); states within
    1e-2."""
    n = 8
    p, x, st = mamba_case(8, 2, 70, n=n)
    st["conv"] = st["conv"].astype(jnp.bfloat16).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    yj, sj = jssm.mamba2_apply(p, xb, n, state={"ssm": jnp.asarray(st["ssm"]),
                                                "conv": jnp.asarray(st["conv"], jnp.bfloat16)})
    xt = torch.as_tensor(x).to(torch.bfloat16)
    yt, stt = ssm.mamba2_apply(tp(p), xt, n, state={"ssm": torch.as_tensor(st["ssm"]),
                                                     "conv": torch.as_tensor(st["conv"]).to(
                                                         torch.bfloat16)})
    assert yt.dtype == torch.bfloat16 and stt["ssm"].dtype == torch.float32
    close(yt, np.asarray(yj.astype(jnp.float32)), 2e-2, "mamba y")
    close(stt["ssm"], sj["ssm"], 1e-2, "mamba ssm")
    p, x, _ = rwkv_case(9, 2, 40, state=False)
    yj, sj = jssm.rwkv6_time_mix(p, jnp.asarray(x, jnp.bfloat16), None)
    yt, stt = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x).to(torch.bfloat16), None)
    close(yt, np.asarray(yj.astype(jnp.float32)), 2e-2, "rwkv y")
    close(stt["wkv"], sj["wkv"], 1e-2, "rwkv wkv")


# --------------------------------------------------- chunked against the scan
DECAYS = {"init": 0.0, "near_one": -4.0, "near_zero": 4.0}


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("s", [1, 5, 64, 130, 257])
def test_ssd_chunked_equals_the_scan(decay, s):
    """S = 1, less than a chunk, one chunk exactly, and several with a
    partial last; a non-zero initial state; ``a_log`` shifted by 0, -4
    (decay near 1) and +4 (near 0).  Output and final state."""
    n = 8
    p, x, st = mamba_case(10 + s, 2, s, n=n, a_shift=DECAYS[decay])
    args = (tp(p), torch.as_tensor(x), n)
    ys, ss = ssm.mamba2_apply(*args, state=tp(st), form="scan")
    yc, sc = ssm.mamba2_apply(*args, state=tp(st), form="chunked")
    close(yc, ys.numpy(), what="y")
    close(sc["ssm"], ss["ssm"].numpy(), what="ssm")
    assert torch.equal(sc["conv"], ss["conv"])


@pytest.mark.parametrize("decay", list(DECAYS))
@pytest.mark.parametrize("s", [1, 7, 16, 48, 101])
def test_wkv_chunked_equals_the_scan(decay, s):
    """As for the SSD, with ``w0`` shifted by 0, -4 (w near 1) and +4 (w
    near exp(-55): every factored exponent of a chunk would overflow)."""
    p, x, st = rwkv_case(20 + s, 2, s, w_shift=DECAYS[decay])
    ys, ss = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x), tp(st), form="scan")
    yc, sc = ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x), tp(st), form="chunked")
    assert bool(torch.isfinite(yc).all())
    close(yc, ys.numpy(), what="y")
    close(sc["wkv"], ss["wkv"].numpy(), what="wkv")


def test_chunked_gradients_equal_the_scan():
    """The chunked forms' gradients (input, every parameter, the initial
    state) against the scan's, within 1e-4 of each tensor's largest."""
    n = 8
    cases = [("mamba", *mamba_case(30, 2, 70, n=n)), ("rwkv", *rwkv_case(31, 2, 40))]
    for name, p, x, st in cases:
        grads = {}
        for form in ("scan", "chunked"):
            pt, xt, stt = tp(p), torch.as_tensor(x), tp(st)
            for t in [xt, *pt.values(), stt["ssm" if name == "mamba" else "wkv"]]:
                t.requires_grad_(True)
            if name == "mamba":
                y, new = ssm.mamba2_apply(pt, xt, n, state=stt, form=form)
                tot = (y * y).sum() + new["ssm"].sum()
                leaves = {"x": xt, "s0": stt["ssm"], **pt}
            else:
                y, new = ssm.rwkv6_time_mix(pt, xt, stt, form=form)
                tot = (y * y).sum() + new["wkv"].sum()
                leaves = {"x": xt, "s0": stt["wkv"],
                          **{k: v for k, v in pt.items() if not k.endswith("_ff")}}
            got = torch.autograd.grad(tot, list(leaves.values()), allow_unused=True)
            grads[form] = {k: g for k, g in zip(leaves, got) if g is not None}
        assert set(grads["scan"]) == set(grads["chunked"])
        for k, g in grads["scan"].items():
            close(grads["chunked"][k], g.numpy(), 1e-4, f"{name} {k}")


def test_wkv_pair_slices_change_no_value(monkeypatch):
    """The pairwise WKV term formed in slices of chunks (a small
    ``RWKV_PAIR_ELEMS``) equals it formed at once, bit for bit, and so do
    its gradients (each slice is recomputed in the backward)."""
    p, x, st = rwkv_case(40, 2, 90)
    out = []
    for elems in (ssm.RWKV_PAIR_ELEMS, 1):
        monkeypatch.setattr(ssm, "RWKV_PAIR_ELEMS", elems)
        pt, xt = tp(p), torch.as_tensor(x).requires_grad_(True)
        for k in ("w0", "wk"):
            pt[k].requires_grad_(True)
        y, s = ssm.rwkv6_time_mix(pt, xt, tp(st), form="chunked")
        grads = torch.autograd.grad((y * y).sum() + s["wkv"].sum(), [xt, pt["w0"], pt["wk"]])
        out.append((y, s["wkv"], *grads))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_form_is_checked_and_defaults_by_length():
    p, x, st = rwkv_case(41, 1, 3)
    with pytest.raises(ValueError, match="form"):
        ssm.rwkv6_time_mix(tp(p), torch.as_tensor(x), tp(st), form="fast")
    assert ssm._pick(None, 1) == "scan" and ssm._pick(None, 2) == "chunked"
