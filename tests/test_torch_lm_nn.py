"""The LM zoo's building blocks (``repro_torch.nn``) against the JAX package.

Every test feeds the same numpy inputs (from a seed) to the reference
function and to its port and states its tolerance.  Float32 throughout: the
point is the algorithm; the bf16 model is held in ``test_torch_lm_models``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import mlp as jmlp
from repro.nn import moe as jmoe
from repro.nn.params import init_params as jinit
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import moe as tmoe

torch.set_num_threads(2)

# float32 ops that XLA and torch implement alike up to their last ulps
# (rsqrt, exp, tanh, sin/cos) and sums taken in another order
F32_RTOL = 1e-5
F32_ATOL = 1e-6


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


# ------------------------------------------------------------------- norms
@pytest.mark.parametrize("scaled", [True, False])
def test_rms_norm(scaled):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 7, 32)).astype(np.float32)
    s = rng.normal(0, 0.2, (32,)).astype(np.float32) if scaled else None
    want = jlayers.rms_norm(jnp.asarray(x), None if s is None else jnp.asarray(s))
    got = tlayers.rms_norm(t(x), None if s is None else t(s))
    close(got, want)


@pytest.mark.parametrize("parametric", [True, False])
def test_layer_norm(parametric):
    """Non-parametric LN is OLMo's; its variance is the population one."""
    rng = np.random.default_rng(1)
    x = (rng.normal(0, 3, (3, 5, 48)) + 2.0).astype(np.float32)
    sc = rng.normal(1, 0.2, (48,)).astype(np.float32) if parametric else None
    b = rng.normal(0, 0.2, (48,)).astype(np.float32) if parametric else None
    want = jlayers.layer_norm(jnp.asarray(x), None if sc is None else jnp.asarray(sc),
                              None if b is None else jnp.asarray(b))
    got = tlayers.layer_norm(t(x), None if sc is None else t(sc), None if b is None else t(b))
    close(got, want)


def test_bf16_norm_rounds_once():
    """bf16 in, float32 inside, bf16 out: equal up to one bf16 ulp (the two
    rsqrt can land on either side of a bf16 rounding boundary)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, (4, 64)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jlayers.layer_norm(xb, None, None).astype(jnp.float32))
    got = tlayers.layer_norm(torch.as_tensor(x).to(torch.bfloat16), None, None).float().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("norm_type,nonparam", [("rmsnorm", False), ("layernorm", False),
                                                ("rmsnorm", True), ("layernorm", True)])
def test_norm_defs_and_apply(norm_type, nonparam):
    from repro_torch.nn.params import flat_defs

    jd = jlayers.norm_defs(3, 16, norm_type, nonparam)
    td = tlayers.norm_defs(3, 16, norm_type, nonparam)
    assert {k: v.shape for k, v in jd.items()} == {k: v.shape for k, v in flat_defs(td).items()}
    rng = np.random.default_rng(3)
    p = {k: rng.normal(0, 0.1, v.shape[1:]).astype(np.float32) for k, v in jd.items()}
    x = rng.normal(0, 1, (2, 4, 16)).astype(np.float32)
    for idx in range(2):
        want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, idx,
                                  jnp.asarray(x), norm_type, nonparam)
        got = tlayers.apply_norm({k: t(v) for k, v in p.items()}, idx, t(x), norm_type, nonparam)
        close(got, want)


# -------------------------------------------------------- embeddings, rope
def test_embed_and_sinusoidal():
    rng = np.random.default_rng(4)
    table = rng.normal(0, 1, (50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 5)).astype(np.int32)
    want = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.bfloat16)
    got = tlayers.embed_lookup(t(table), t(ids), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    close(tlayers.sinusoidal_positions(17, 12), jlayers.sinusoidal_positions(17, 12))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    """Float32 inside; angles up to 60 rad, where sin/cos differ by ulps."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 61, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(61), (2, 61)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.rope(t(x), t(pos), theta)
    close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "tanh", "relu2"])
def test_activation_fn(name):
    """``gelu`` is the tanh approximation (``jax.nn.gelu``'s default)."""
    x = np.random.default_rng(6).normal(0, 3, (1000,)).astype(np.float32)
    want = jlayers.activation_fn(name)(jnp.asarray(x))
    got = tlayers.activation_fn(name)(t(x))
    close(got, want, rtol=2e-6, atol=1e-6)


# ---------------------------------------------------------------- attention
def _qkv(rng, b, s, t_, n, k, hd):
    q = rng.normal(0, 1, (b, s, n, hd)).astype(np.float32)
    kk = rng.normal(0, 1, (b, t_, k, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t_, k, hd)).astype(np.float32)
    return q, kk, v


@pytest.mark.parametrize("causal,window,n,kv,s,qc", [
    (True, None, 4, 4, 32, 8),      # causal, MHA
    (True, 5, 4, 2, 32, 8),         # windowed, GQA
    (True, None, 6, 2, 37, 16),     # GQA, padded last chunk
    (False, None, 4, 1, 21, 8),     # bidirectional, MQA, padded
    (True, 3, 4, 2, 21, 32),        # window, one chunk larger than S
])
def test_attention_core(causal, window, n, kv, s, qc):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, s, s, n, kv, 8)
    jc = jattn.AttnCfg(n_heads=n, n_kv=kv, head_dim=8, causal=causal, q_chunk=qc)
    tc = tattn.AttnCfg(n_heads=n, n_kv=kv, head_dim=8, causal=causal, q_chunk=qc)
    want = jattn.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                                window=window)
    got = tattn.attention_core(t(q), t(k), t(v), tc, window=window)
    assert tuple(got.shape) == (2, s, n, 8)
    close(got, want, rtol=1e-5, atol=2e-6)


def test_attention_core_gradients_with_remat_chunks():
    """The checkpointed chunks give the reference's vjp (``jax.checkpoint``
    per chunk there)."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 20, 20, 4, 2, 8)
    g = rng.normal(0, 1, (2, 20, 4, 8)).astype(np.float32)
    jc = jattn.AttnCfg(n_heads=4, n_kv=2, head_dim=8, q_chunk=8, remat_chunks=True)
    tc = tattn.AttnCfg(n_heads=4, n_kv=2, head_dim=8, q_chunk=8, remat_chunks=True)
    jf = lambda a, b, c: jnp.sum(jattn.attention_core(a, b, c, jc, window=6) * g)
    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    out = tattn.attention_core(tq, tk, tv, tc, window=6)
    got = torch.autograd.grad(torch.sum(out * t(g)), (tq, tk, tv))
    for a, b in zip(got, want):
        close(a, b, rtol=1e-4, atol=1e-5)


def _attn_params(rng, d, n, kv, hd, qk_norm, qkv_bias):
    defs = jattn.attn_defs(1, d, n, kv, hd, qk_norm, qkv_bias)
    p = jax.tree.map(lambda a: np.asarray(a)[0], jinit(defs, jax.random.PRNGKey(1)))
    for key in p:
        if key in ("bq", "bk", "bv", "q_scale", "k_scale"):
            p[key] = rng.normal(0, 0.3, p[key].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("qk_norm,qkv_bias,window", [(False, False, None), (True, False, 4),
                                                     (False, True, None)])
def test_multihead_and_decode_attention(qk_norm, qkv_bias, window):
    """Prefill-style attention and one decode step against a cache whose
    rows past the index are garbage (masked); the port writes the new row in
    place, the reference returns an updated copy."""
    rng = np.random.default_rng(9)
    d, n, kv, hd, s, tt, idx = 32, 4, 2, 8, 11, 16, 11
    p = _attn_params(rng, d, n, kv, hd, qk_norm, qkv_bias)
    jc = jattn.AttnCfg(n_heads=n, n_kv=kv, head_dim=hd, qk_norm=qk_norm,
                       qkv_bias=qkv_bias, q_chunk=4)
    tc = tattn.AttnCfg(n_heads=n, n_kv=kv, head_dim=hd, qk_norm=qk_norm,
                       qkv_bias=qkv_bias, q_chunk=4)
    x = rng.normal(0, 1, (2, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    want, (jk, jv) = jattn.multihead_attention(jp, jnp.asarray(x), jc, positions=jnp.asarray(pos),
                                               window=window, return_kv=True)
    got, (tk, tv) = tattn.multihead_attention(tp, t(x), tc, positions=t(pos),
                                              window=window, return_kv=True)
    # projections and the output projection sum 32 products in another
    # order: within 1e-5 of the largest output
    big = lambda a: 1e-5 * float(np.abs(np.asarray(a)).max())
    close(got, want, rtol=1e-5, atol=big(want))
    close(tk, jk, atol=big(jk))
    close(tv, jv, atol=big(jv))

    kc = rng.normal(0, 1, (2, kv, tt, hd)).astype(np.float32)
    vc = rng.normal(0, 1, (2, kv, tt, hd)).astype(np.float32)
    x1 = rng.normal(0, 1, (2, 1, d)).astype(np.float32)
    yw, kw, vw = jattn.decode_attention(jp, jnp.asarray(x1), jc, jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(idx, jnp.int32),
                                        window=window)
    tkc, tvc = t(kc), t(vc)
    yg, kg, vg = tattn.decode_attention(tp, t(x1), tc, tkc, tvc,
                                        torch.tensor(idx, dtype=torch.int32), window=window)
    assert kg is tkc and vg is tvc, "the cache is updated in place"
    close(yg, yw, rtol=1e-5, atol=big(yw))
    close(kg, kw, atol=big(kw))
    close(vg, vw, atol=big(vw))


def test_cache_defs_shapes():
    from repro_torch.nn.params import flat_defs

    jd = jattn.cache_defs(3, 2, 40, 4, 16)
    td = flat_defs(tattn.cache_defs(3, 2, 40, 4, 16))
    assert {k: v.shape for k, v in jd.items()} == {k: v.shape for k, v in td.items()}
    assert td["k"].dtype == torch.bfloat16


# ---------------------------------------------------------------------- MoE
def test_top_k_dispatch_matches():
    rng = np.random.default_rng(10)
    logits = rng.normal(0, 2, (2, 24, 4)).astype(np.float32)
    gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    for k, cap in [(1, 5), (2, 6), (2, 24)]:
        jd, jc, ja = jmoe._top_k_dispatch(jnp.asarray(gates), k, cap)
        td, tc, ta = tmoe._top_k_dispatch(t(gates), k, cap)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        close(ta, ja)


def test_capacity_drops_overflow_tokens():
    gates = np.zeros((1, 8, 2), np.float32)
    gates[..., 0] = 1.0
    jd, _, _ = jmoe._top_k_dispatch(jnp.asarray(gates), 1, capacity=3)
    td, _, _ = tmoe._top_k_dispatch(t(gates), 1, capacity=3)
    assert float(td[..., 0, :].sum()) == 3.0
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_apply_values_and_gradients(cf):
    """Capacity factor 0.5 drops tokens; gradients reach the router through
    the combine weights and the load-balance loss."""
    defs = jmoe.moe_defs(1, 8, 16, 4)
    p = jax.tree.map(lambda a: np.asarray(a)[0], jinit(defs, jax.random.PRNGKey(2)))
    x = np.random.default_rng(11).normal(0, 1, (2, 16, 8)).astype(np.float32)

    def jrun(pp):
        y, aux = jmoe.moe_apply(pp, jnp.asarray(x), jax.nn.silu, top_k=2, capacity_factor=cf)
        return jnp.mean(y ** 2) + 0.01 * aux, (y, aux)

    (jl, (jy, ja)), jg = jax.value_and_grad(jrun, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: t(v).requires_grad_(True) for k, v in p.items()}
    ty, ta = tmoe.moe_apply(tp, t(x), tlayers.activation_fn("silu"), top_k=2, capacity_factor=cf)
    tl = torch.mean(ty ** 2) + 0.01 * ta
    close(ty, jy)
    close(ta, ja)
    grads = torch.autograd.grad(tl, list(tp.values()))
    for (k, _), g in zip(tp.items(), grads):
        close(g, jg[k], rtol=1e-4, atol=1e-6)
        assert float(g.abs().sum()) > 0, k


# ---------------------------------------------------------------- GLU / MLP
def _ffn_params(kind, quant, seed=3):
    defs = (jmlp.glu_defs if kind == "glu" else jmlp.mlp_defs)(1, 16, 32, quant)
    p = jax.tree.map(lambda a: np.asarray(a)[0], jinit(defs, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in p:
        if k in ("b1", "b2"):
            p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
        elif "_q" in k:       # spread the widths so SAT clips and widths prune
            p[k] = (p[k] + rng.choice([-3.4, -1.2, 0.3, 1.6], size=p[k].shape)).astype(np.float32)
    return p


def _codes(a, f):
    return np.round(np.asarray(a, np.float64) * 2.0 ** f)


@pytest.mark.parametrize("kind", ["glu", "mlp"])
@pytest.mark.parametrize("quant", ["none", "hgq"])
def test_ffn_values_ebops_and_gradients(kind, quant):
    """GLU/MLP forward, EBOPs and the gradients of ``sum(y * g) + 1e-3 *
    EBOPs``, the bit-width parameters' included.  The inputs are the same,
    so every quantizer sees the same weights and input; only its hidden
    input ``h`` comes out of float32 matmuls summed in another order, and a
    code of ``h`` that lands on the other side of a rounding boundary moves
    y by one grid step times its weight row.  The test counts those flips
    (at most 2 of 2 x 12 x 32 here) and widens y's bound by them; the
    width gradients, sums of rounding residuals over all elements, are held
    to 2e-4 of their size plus one flipped term each."""
    rng = np.random.default_rng(12)
    p = _ffn_params(kind, quant)
    x = rng.normal(0, 2, (2, 12, 16)).astype(np.float32)
    g = rng.normal(0, 1, (2, 12, 16)).astype(np.float32)
    japply = jmlp.glu_apply if kind == "glu" else jmlp.mlp_apply
    tapply = tmlp.glu_apply if kind == "glu" else tmlp.mlp_apply

    def jloss(pp):
        y, eb = japply(pp, jnp.asarray(x), "silu", quant)
        return jnp.sum(y * g) + 1e-3 * eb, (y, eb)

    (_, (jy, jeb)), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: t(v).requires_grad_(True) for k, v in p.items()}
    ty, teb = tapply(tp, t(x), "silu", quant)
    grads = torch.autograd.grad(torch.sum(ty * t(g)) + 1e-3 * teb, list(tp.values()))

    np.testing.assert_array_equal(np.float32(teb.detach()), np.float32(jeb))
    flips, step_w = 0, 0.0
    if quant == "hgq":
        hname, wname = ("down", "w_down") if kind == "glu" else ("w2", "w2")
        f = float(np.clip(np.round(p[f"{hname}_qaf"]), -8, 12))
        xj, xt = jnp.asarray(x), t(x)
        if kind == "glu":
            qa = {"f": jnp.asarray(p["gate_qaf"]), "i": jnp.asarray(p["gate_qai"])}
            from repro.core.quant import fake_quant as jfq
            xq = jfq(qa, xj, jmlp.QA_LM)
            qw = lambda n: jfq({"f": jnp.asarray(p[f"{n}_qwf"]), "i": jnp.asarray(p[f"{n}_qwi"])},
                               jnp.asarray(p[f"w_{n}"]), jmlp.QW_LM)
            jh = jax.nn.silu(xq @ qw("gate")) * (xq @ qw("up"))
            th = (tlayers.activation_fn("silu")(t(np.asarray(xq)) @ t(np.asarray(qw("gate"))))
                  * (t(np.asarray(xq)) @ t(np.asarray(qw("up")))))
        else:
            from repro.core.quant import fake_quant as jfq
            xq = jfq({"f": jnp.asarray(p["w1_qaf"]), "i": jnp.asarray(p["w1_qai"])}, xj, jmlp.QA_LM)
            w1 = jfq({"f": jnp.asarray(p["w1_qwf"]), "i": jnp.asarray(p["w1_qwi"])},
                     jnp.asarray(p["w1"]), jmlp.QW_LM)
            jh = jax.nn.silu(xq @ w1 + p["b1"])
            th = tlayers.activation_fn("silu")(t(np.asarray(xq)) @ t(np.asarray(w1)) + t(p["b1"]))
        flips = int((_codes(jh, f) != _codes(th.numpy(), f)).sum())
        assert flips <= 2, flips
        step_w = 2.0 ** -f * float(np.abs(p[wname]).max()) * 1.5   # the weight, quantized
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 + flips * step_w)
    for (k, _), gt in zip(tp.items(), grads):
        want = np.asarray(jg[k])
        if "_q" in k:
            tol = 2e-4 * np.abs(want).max() + 1e-6 + flips * 2.0 ** -f * np.abs(g).max() * 16
        else:
            tol = 1e-4 * np.abs(want).max() + 1e-6 + flips * 16 * np.abs(g).max()
        np.testing.assert_allclose(gt.numpy(), want, rtol=0, atol=tol, err_msg=k)


def test_discarded_up_quantizer_is_not_launched(monkeypatch):
    """A GLU forward quantizes five tensors (gate w, gate x, up w, down w,
    down h); the reference's sixth, ``up``'s input, is computed and thrown
    away there, and not computed here."""
    from repro_torch.core import quant

    calls = []
    original = quant._fq_forward
    monkeypatch.setattr(quant, "_fq_forward",
                        lambda x, f, i, s, o: calls.append(tuple(x.shape)) or original(x, f, i, s, o))
    p = _ffn_params("glu", "hgq")
    tmlp.glu_apply({k: t(v) for k, v in p.items()},
                   t(np.ones((2, 3, 16), np.float32)), "silu", "hgq")
    assert calls == [(16, 32), (2, 3, 16), (16, 32), (32, 16), (2, 3, 32)]
