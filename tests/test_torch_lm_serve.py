"""``DecoderLM.prefill`` / ``decode_step`` against the reference, per arch,
and the serving launcher's ``--engine float`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lm_models import DECODER_ARCHS, batch, jbatch, pair, tbatch

torch.set_num_threads(2)

B, S, GROW = 2, 12, 4
# the reference's own prefill/decode consistency bound (tests/test_models.py)
CONSIST_ATOL, CONSIST_RTOL = 0.15, 0.05


def _jgrow(cache, t):
    out = dict(cache)
    for k in ("k", "v"):
        pad = [(0, 0)] * 5
        pad[3] = (0, t)
        out[k] = jnp.pad(cache[k], pad)
    return out


def _both(arch, dtype):
    jm, params, tm = pair(arch, dtype)
    nb = batch(tm.cfg, B, S + 1, mode="prefill", seed=1)
    pf = {k: (v[:, :S] if k == "tokens" else v) for k, v in nb.items()}
    jl, jc = jm.prefill(params, jbatch(pf))
    with torch.no_grad():
        tl, tc = tm.prefill(tbatch(pf), cache_len=S + GROW)
    jd, _ = jm.decode_step(params, _jgrow(jc, GROW), jnp.asarray(nb["tokens"][:, S]))
    with torch.no_grad():
        td, tc2 = tm.decode_step(tc, torch.as_tensor(nb["tokens"][:, S]))
    return (jl, jc, jd), (tl, tc, td, tc2), (tm, nb)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_and_decode_float32(arch):
    """Float32: prefill and decode logits within 1e-4 of the largest logit
    (float32 sums in another order through two or four layers; gemma3's
    smoke config is the worst conditioned), the caches' first S positions
    within 1e-5 of their largest entry and the grown positions zero, and
    the decode step's own row written in place at index S."""
    (jl, jc, jd), (tl, tc, td, tc2), _ = _both(arch, "float32")
    for got, want in ((tl, jl), (td, jd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    for k in ("k", "v"):
        want = np.asarray(jc[k])
        got = tc[k].numpy()
        assert got.shape == want.shape[:3] + (S + GROW,) + want.shape[4:]
        np.testing.assert_allclose(got[:, :, :, :S], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert not got[:, :, :, S + 1:].any()
        assert got[:, :, :, S].any(), "the decode step wrote its row in place"
    assert int(tc["index"]) == S and int(tc2["index"]) == S + 1
    assert tc2["k"] is tc["k"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_and_decode_bf16(arch):
    """The default bf16: logits against the reference's within its own
    prefill/decode consistency bound (atol 0.15, rtol 0.05); then the
    port's own invariant, decode after prefill(S) against prefill(S+1), at
    the same bound."""
    (jl, _, jd), (tl, _, td, _), (tm, nb) = _both(arch, "bfloat16")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=CONSIST_ATOL, rtol=CONSIST_RTOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=CONSIST_ATOL, rtol=CONSIST_RTOL)
    with torch.no_grad():
        full, _ = tm.prefill(tbatch(nb))
    np.testing.assert_allclose(td.numpy(), full.numpy(), atol=CONSIST_ATOL, rtol=CONSIST_RTOL)


def test_a_longer_cache_is_the_grown_cache():
    """``prefill(cache_len=T)`` equals the reference launcher's growth of a
    prefill cache: zeros padded along the sequence axis."""
    _, _, tm = pair("gemma3_12b", "float32")
    nb = tbatch(batch(tm.cfg, B, S, mode="prefill"))
    with torch.no_grad():
        l1, c1 = tm.prefill(nb)
        l2, c2 = tm.prefill(nb, cache_len=S + 5)
    assert torch.equal(l1, l2)
    for k in ("k", "v"):
        assert torch.equal(torch.nn.functional.pad(c1[k], (0, 0, 0, 5)), c2[k])


def test_serve_launcher_float_engine_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--engine", "float", "--arch", "qwen3_14b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "5"])
    assert out["tokens"].shape == (2, 5)
    assert out["b1_per_call"] == [0] * 5          # the CPU runs B1's plain version
    # k and v, each (L=2, B=2, K=2, T=16+5, hd=8) in bf16
    assert out["kv_bytes"] == 2 * (2 * 2 * 2 * 21 * 8) * 2
    text = capsys.readouterr().out
    assert "prefill(16 tok)" in text and "ms/tok" in text


def test_serve_launcher_float_defaults_and_errors():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit):
        serve.main(["--engine", "float", "--device", "cpu"])            # no --arch
    with pytest.raises(SystemExit):
        serve.main(["--engine", "float", "--arch", "olmo_1b", "--require-fused",
                    "--device", "cpu"])
    out = serve.main(["--engine", "float", "--arch", "phi35_moe", "--smoke", "--device", "cpu"])
    assert out["tokens"].shape == (4, 16)          # the reference's --batch 4 --gen 16


@pytest.mark.parametrize("dtype,y_rtol,kv_rtol", [("float32", 1e-4, 1e-5),
                                                  ("bfloat16", 2e-2, 1e-2)])
def test_decode_layer_by_layer_at_16_layers(dtype, y_rtol, kv_rtol):
    """OLMo's smoke widths at OLMo-1B's 16 layers, where whole-model decode
    against prefill is swamped by the init's chaos: each layer's decode step,
    fed the full forward's input at its position, against that forward.
    Prefill's cache rows equal its layers' K/V bit for bit and are zero
    past the sequence; a decode step's output is within ``y_rtol`` of the
    forward's largest entry at that position and the K/V row it writes
    within ``kv_rtol`` of prefill's (float32: sums in another order, a
    flipped HGQ code at most; bf16: a rounding step is 2^-8 of a value)."""
    import dataclasses

    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_smoke("olmo_1b"), n_layers=16, dtype=dtype)
    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    seq = tbatch(batch(cfg, B, S + GROW, mode="prefill", seed=4))["tokens"]
    n = seq.shape[1]
    with torch.no_grad():
        _, cache = tm.prefill({"tokens": seq}, cache_len=n + 3)
        blocks = tm._blocks()
        xs = [tm._embed_inputs({"tokens": seq})]
        for l, w in enumerate(tm._windows):
            x, (k, v), _, _ = tm._block(tm._layer(blocks, l), xs[-1], w, tm._positions(B, n),
                                        return_kv=True)
            assert torch.equal(cache["k"][l, :, :, :n], k.transpose(1, 2)), l
            assert torch.equal(cache["v"][l, :, :, :n], v.transpose(1, 2)), l
            xs.append(x)
        assert not cache["k"][:, :, :, n:].any() and not cache["v"][:, :, :, n:].any()
        for pos in range(S, n):
            index = torch.full((), pos, dtype=torch.int32)
            for l, w in enumerate(tm._windows):
                want = {kv: cache[kv][l, :, :, pos].float() for kv in ("k", "v")}
                y = tm._block(tm._layer(blocks, l), xs[l][:, pos:pos + 1], w, None,
                              cache_kv=(cache["k"][l], cache["v"][l]), index=index)[0]
                full = xs[l + 1][:, pos].float()
                np.testing.assert_allclose(y[:, 0].float().numpy(), full.numpy(), rtol=0,
                                           atol=y_rtol * float(full.abs().max()),
                                           err_msg=f"position {pos}, layer {l}")
                for kv, wt in want.items():
                    np.testing.assert_allclose(cache[kv][l, :, :, pos].float().numpy(),
                                               wt.numpy(), rtol=0,
                                               atol=kv_rtol * float(wt.abs().max()),
                                               err_msg=f"{kv} at {pos}, layer {l}")
