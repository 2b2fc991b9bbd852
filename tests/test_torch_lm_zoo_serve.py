"""``ZambaHybrid``, ``RWKV6LM`` and ``WhisperEncDec`` serving (``prefill``,
``decode_step``) against the reference's, and ``nn/attention.py``'s
cross-attention arguments (``kv``, ``prefix``, ``causal``,
``update_cache``) against the reference's ``repro.nn.attention``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro.nn.params import init_params as jinit
from repro_torch.nn import attention as tattn
from test_torch_lm_models import pair
from test_torch_lm_zoo import ZOO, jb, tb, zbatch

torch.set_num_threads(2)

B, S, GROW = 2, 12, 4


# ------------------------------------------------------- prefill and decode
def _jgrow(cache, t):
    """The reference test's growth of a prefill cache: self K/V padded."""
    out = dict(cache)
    for k in ("k", "v"):
        if k in cache:
            pad = [(0, 0)] * 5
            pad[3] = (0, t)
            out[k] = jnp.pad(cache[k], pad)
    return out


def _serve_both(arch, dtype, **over):
    """Prefill S tokens and one decode step in both packages.  Returns the
    reference's (logits, cache, decode logits), the port's (logits, a copy
    of its prefill cache, decode logits, the decode's cache, the prefill's
    cache tensors as the decode left them) and (port model, batch)."""
    jm, params, tm = pair(arch, dtype, **over)
    nb = zbatch(tm.cfg, B, S + 1, mode="prefill", seed=1)
    pf = {k: (v[:, :S] if k == "tokens" else v) for k, v in nb.items()}
    jl, jc = jm.prefill(params, jb(pf))
    jc = jax.tree.map(np.asarray, jc)
    with torch.no_grad():
        tl, tc = tm.prefill(tb(pf), cache_len=S + GROW)
    tc0 = {k: v.clone() for k, v in tc.items()}
    jd, _ = jm.decode_step(params, _jgrow(jc, GROW), jnp.asarray(nb["tokens"][:, S]))
    with torch.no_grad():
        td, tc2 = tm.decode_step(tc, torch.as_tensor(nb["tokens"][:, S]))
    return (jl, jc, jd), (tl, tc0, td, tc2, tc), (tm, nb)


def _n_used(tm):
    """Zamba's K/V slots an output reads: one per shared-block application."""
    return sum(tm._flags) if hasattr(tm, "_flags") else None


# float32 logits within 1e-4 of the largest, cache entries within 1e-5;
# Whisper's within 3e-3 (seen 8.2e-4 and 3.2e-4; 1.4e-5 for the logits with
# its quantizers off: flipped activation codes)
LOGITS_F32 = {"zamba2_12b": 1e-4, "rwkv6_16b": 1e-4, "whisper_base": 3e-3}
CACHE_F32 = {"zamba2_12b": 1e-5, "rwkv6_16b": 1e-5, "whisper_base": 3e-3}


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_float32(arch):
    """Float32: prefill and decode logits within ``LOGITS_F32``;
    every cache tensor of the reference's shape (self K/V grown by GROW
    positions, zero there) and within ``CACHE_F32`` of its largest entry (Zamba2:
    the used K/V slots, ROADMAP C14); the decode step's states and K/V rows
    written in place."""
    (jl, jc, jd), (tl, tc, td, tc2, live), (tm, _) = _serve_both(arch, "float32")
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGITS_F32[arch] * np.abs(want).max())
    assert set(tc) == set(jc)
    for k, want in jc.items():
        got = tc[k].float().numpy()
        if k == "index":
            assert int(got) == S
            continue
        if k in ("k", "v"):
            assert got.shape == want.shape[:3] + (S + GROW,) + want.shape[4:]
            assert not got[..., S:, :].any()
            got = got[..., :S, :]
            if arch == "zamba2_12b":
                got, want = got[:_n_used(tm)], want[:_n_used(tm)]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=CACHE_F32[arch] * np.abs(want).max(),
                                   err_msg=k)
    assert int(tc2["index"]) == S + 1
    for k in tc2:
        if k != "index":
            assert tc2[k] is live[k], k
    if "k" in tc:
        assert tc2["k"][..., S, :].any(), "the decode step wrote its row in place"
    if "wkv" in tc:
        assert not torch.equal(tc2["wkv"], tc["wkv"])


CONSIST = dict(atol=0.15, rtol=0.05)   # the reference's own bound (tests/test_models.py)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_decode_bf16(arch):
    """The default bf16: logits against the reference's within its own
    prefill/decode consistency bound; then decode after prefill(S) against
    prefill(S + 1), at the same bound."""
    (jl, _, jd), (tl, _, td, _, _), (tm, nb) = _serve_both(arch, "bfloat16")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **CONSIST)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **CONSIST)
    with torch.no_grad():
        full, _ = tm.prefill(tb(nb))
    np.testing.assert_allclose(td.numpy(), full.numpy(), **CONSIST)


def test_zamba_spare_slot_c14():
    """Five layers with ``attn_every`` 2: three K/V slots, two applications.
    The reference's prefill leaves the K/V of layer 4 (not applied) in slot
    2, which no output reads; the port leaves it zero (ROADMAP C14).  The
    used slots agree, and so do the decode logits."""
    (jl, jc, jd), (tl, tc, td, _, _), (tm, _) = _serve_both("zamba2_12b", "float32",
                                                            n_layers=5)
    assert tm.n_app == 3 and _n_used(tm) == 2
    assert np.abs(jc["k"][2]).max() > 0 and not tc["k"][2].any()
    np.testing.assert_allclose(tc["k"][:2, :, :, :S].numpy(), jc["k"][:2], rtol=0,
                               atol=1e-5 * np.abs(jc["k"][:2]).max())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jd)).max())


def test_prefill_cache_len_and_whisper_positions():
    """``cache_len``: the self K/V grown with zeros (RWKV ignores it); a
    shorter one refused; a Whisper prompt past ``MAX_DEC_POS`` refused."""
    for arch in ZOO:
        _, _, tm = pair(arch, "float32")
        nb = tb(zbatch(tm.cfg, B, S, mode="prefill"))
        with torch.no_grad():
            l1, c1 = tm.prefill(nb)
            l2, c2 = tm.prefill(nb, cache_len=S + 5)
        assert torch.equal(l1, l2)
        for k in c1:
            want = (torch.nn.functional.pad(c1[k], (0, 0, 0, 5)) if k in ("k", "v")
                    else c1[k])
            assert torch.equal(c2[k], want), (arch, k)
        if arch != "rwkv6_16b":
            with pytest.raises(ValueError, match="shorter"):
                tm.prefill(nb, cache_len=S - 1)
    from repro_torch.models.whisper import MAX_DEC_POS
    with pytest.raises(ValueError, match="positions"):
        tm._dec_inputs(torch.zeros((1, MAX_DEC_POS + 1), dtype=torch.int32))


def _whisper():
    _, _, tm = pair("whisper_base", "float32")
    return tm, tb(zbatch(tm.cfg, B, S, mode="prefill"))


def test_whisper_prefill_past_positions_refused_c16():
    """C16: a cache past ``MAX_DEC_POS`` is refused at prefill (a host int,
    no sync), where the reference's ``jnp.take`` returns NaN logits there;
    a cache of exactly ``MAX_DEC_POS`` positions is taken."""
    tm, nb = _whisper()
    with pytest.raises(ValueError, match="positions"):
        with torch.no_grad():
            tm.prefill(nb, cache_len=tm.max_positions + 4)
    from repro_torch.models.whisper import MAX_DEC_POS
    assert tm.max_positions == MAX_DEC_POS


def test_whisper_decode_past_the_cache_raises_c16():
    """C16: a decode past the cache raises, where the reference's
    ``dynamic_update_slice`` clamps and overwrites the last row."""
    tm, nb = _whisper()
    with torch.no_grad():
        _, cache = tm.prefill(nb)
        tok = torch.zeros((B,), dtype=torch.int32)
        with pytest.raises((IndexError, RuntimeError)):
            tm.decode_step(cache, tok)        # index S into a cache of S rows


# ------------------------------------------------- attention's new arguments
def _attn_case(seed=0, causal=True):
    cfg_j = jattn.AttnCfg(n_heads=4, n_kv=2, head_dim=8, q_chunk=4, causal=causal,
                          use_rope=False)
    cfg_t = tattn.AttnCfg(n_heads=4, n_kv=2, head_dim=8, q_chunk=4, causal=causal,
                          use_rope=False)
    defs = jattn.attn_defs(1, 16, 4, 2, 8)
    p = {k: np.array(v[0]) for k, v in jinit(defs, jax.random.PRNGKey(seed)).items()}
    p.update({f"x_{k}": v * 0.5 for k, v in p.items()})
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 10, 16)).astype(np.float32)
    src = rng.normal(0, 1, (2, 7, 16)).astype(np.float32)
    return cfg_j, cfg_t, p, {k: torch.as_tensor(v) for k, v in p.items()}, x, src


def test_cross_attention_and_prefix_against_the_reference():
    """``kv=`` (cross K/V from another source, non-causal) with
    ``prefix="x_"``, and ``return_kv`` still giving the self K/V; within
    1e-5 of the largest output."""
    cj, ct, p, pt, x, src = _attn_case()
    kj = jnp.einsum("btd,dkh->btkh", src, p["x_wk"])
    vj = jnp.einsum("btd,dkh->btkh", src, p["x_wv"])
    yj, (skj, svj) = jattn.multihead_attention(p, jnp.asarray(x), cj, kv=(kj, vj), prefix="x_",
                                               return_kv=True)
    yt, (skt, svt) = tattn.multihead_attention(
        pt, torch.as_tensor(x), ct, kv=(torch.as_tensor(np.asarray(kj)),
                                        torch.as_tensor(np.asarray(vj))),
        prefix="x_", return_kv=True)
    for got, want in ((yt, yj), (skt, skj), (svt, svj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert not torch.allclose(yt, tattn.multihead_attention(pt, torch.as_tensor(x), ct))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_core_causal_override(causal):
    """``causal=`` overrides the config's flag, either way."""
    cj, ct, p, pt, x, _ = _attn_case(1, causal=not causal)
    q, k, v = jattn.project_qkv(p, jnp.asarray(x), cj, None)
    want = np.asarray(jattn.attention_core(q, k, v, cj, causal=causal))
    got = tattn.attention_core(*(torch.as_tensor(np.asarray(a)) for a in (q, k, v)), ct,
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("update", [True, False])
def test_decode_attention_prefix_and_update_cache(update):
    """``decode_attention`` with ``prefix`` and ``update_cache``: the output
    against the reference's, the cache written in place only with
    ``update_cache``."""
    cj, ct, p, pt, x, _ = _attn_case(2)
    rng = np.random.default_rng(3)
    kc = rng.normal(0, 1, (2, 2, 9, 8)).astype(np.float32)
    vc = rng.normal(0, 1, (2, 2, 9, 8)).astype(np.float32)
    idx = 5
    yj, kj, vj = jattn.decode_attention(p, jnp.asarray(x[:, :1]), cj, jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(idx, jnp.int32),
                                        prefix="x_", update_cache=update)
    kt, vt = torch.as_tensor(kc.copy()), torch.as_tensor(vc.copy())
    yt, kt2, vt2 = tattn.decode_attention(pt, torch.as_tensor(x[:, :1]), ct, kt, vt,
                                          torch.tensor(idx, dtype=torch.int32), prefix="x_",
                                          update_cache=update)
    want = np.asarray(yj)
    np.testing.assert_allclose(yt.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert kt2 is kt and vt2 is vt
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-5)
    assert torch.equal(kt, torch.as_tensor(kc)) != update
