"""``ZambaHybrid``, ``RWKV6LM`` and ``WhisperEncDec`` (``repro_torch.models``)
against the reference's: loss, gradients, parameter defs and input specs.

The three smoke configs run through both packages on the same numpy
parameters (the reference's init, crossed with
``interop.lm_params_from_numpy``) and the same batch; Whisper's stub
``frames`` are bf16 values.  Float32 holds the algorithm to tight bounds,
the bf16 default to loose ones, with reasons at each bound.  The
reference's init makes these models ill-conditioned (ROADMAP C13): with its
own parameters moved by 1e-7 relative, the reference's float32 gradients
move by up to 1.0e-3 (Zamba2) and 4.0e-3 (Whisper) of their largest, and
its own bf16 gradients have a cosine down to 0.43 (Zamba2) and -0.9999
(Whisper's encoder widths) with its float32 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.registry import build_model as jbuild
from repro.nn.params import count_params as jcount
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models.registry import model_class
from repro_torch.nn.params import count_params, flat_defs
from test_torch_lm_models import pair

torch.set_num_threads(2)

ZOO = ["zamba2_12b", "rwkv6_16b", "whisper_base"]
BETA = 1e-7          # weight of EBOPs in the objective, so their gradients count


def zbatch(cfg, b, s, mode="train", seed=0):
    """The same batch as numpy for both packages: tokens (and labels), and
    Whisper's stub frames as bf16 values."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, 50, (b, s)).astype(np.int32)}
    if mode == "train":
        out["labels"] = rng.integers(1, 50, (b, s)).astype(np.int32)
    if cfg.family == "encdec" and mode != "decode":
        f = rng.normal(0, 1, (b, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
        out["frames"] = np.array(jnp.asarray(f, jnp.bfloat16).astype(jnp.float32))
    return out


def jb(nb):
    return {k: jnp.asarray(v, jnp.bfloat16) if k == "frames" else jnp.asarray(v)
            for k, v in nb.items()}


def tb(nb, device="cpu"):
    return {k: torch.as_tensor(v, device=device).to(torch.bfloat16) if k == "frames"
            else torch.as_tensor(v, device=device) for k, v in nb.items()}


def cosine(a, b):
    """Cosine of two arrays as vectors; 1 when both are zero (a width that
    neither clips nor saturates has no gradient)."""
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.sqrt(a @ a), np.sqrt(b @ b)
    return 1.0 if na == 0 and nb == 0 else float(a @ b / max(na * nb, 1e-300))


def objectives(arch, dtype):
    jm, params, tm = pair(arch, dtype)
    nb = zbatch(tm.cfg, 2, 32)

    def f(p):
        ce, m = jm.loss(p, jb(nb))
        return ce + BETA * m["ebops"], m

    (jl, jmet), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    ce, tmet = tm.loss(tb(nb))
    total = ce + BETA * tmet["ebops"]
    ps = tm.flat_params()
    tg = dict(zip(ps, torch.autograd.grad(total, list(ps.values()))))
    return (float(jl), jmet, interop.unnest(jax.tree.map(np.asarray, jg))), \
        (float(total.detach()), {k: v.detach() for k, v in tmet.items()}, tg)


# float32 gradients: Zamba2 and RWKV-6 within 1e-3 of each tensor's largest
# (seen 7.8e-4, 1.2e-5); Whisper within 1e-2 (seen 7.4e-3; 5.8e-4 with its
# quantizers off, so the rest are activation codes that flip between the
# packages and move their rows' gradients).  The HGQ widths' gradients by
# direction: cosine >= 0.999 (seen 0.99994), within 5e-2 of their largest.
GRAD_F32 = {"zamba2_12b": 1e-3, "rwkv6_16b": 1e-3, "whisper_base": 1e-2}
# the loss within 1e-5 relative; Whisper's, whose flipped activation codes
# move it too, within 1e-4 (seen 1.1e-5)
LOSS_F32 = {"zamba2_12b": 1e-5, "rwkv6_16b": 1e-5, "whisper_base": 1e-4}


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_gradients_float32(arch):
    """Loss and metrics as ``LOSS_F32``; gradients as ``GRAD_F32``."""
    (jl, jmet, jg), (tl, tmet, tg) = objectives(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_F32[arch])
    for k in ("ce", "ebops", "aux_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=LOSS_F32[arch],
                                   err_msg=k)
    assert set(jg) == set(tg)
    for k, g in tg.items():
        want, got = jg[k], g.numpy()
        err = float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)
        if "_q" in k:
            assert err <= 5e-2 and cosine(got, want) >= 0.999, (k, err)
        else:
            assert err <= GRAD_F32[arch], (k, err)


# bf16: each gradient tensor by its direction against the reference's bf16
# one, the lowest cosine and the median of the non-width tensors (seen:
# Zamba2 0.686 / 0.899, RWKV-6 0.9997 / 0.9997).  Whisper's smoke model is
# chaotic in bf16: both packages' encoder outputs part from the float32 one
# by 16% of its largest and the decoder's by 45%, and the reference's own
# bf16 gradients against its float32 ones have a median cosine of 0.22 to
# 0.71 over four batches.  So its tensors are held by the median only (seen
# 0.43 on this batch, 0.74 to 0.85 on three others), and the gradients
# nearest the loss, of the decoder's final norm, by cosine >= 0.99 (seen
# 0.998).
COS_BF16 = {"zamba2_12b": (0.55, 0.8), "rwkv6_16b": (0.999, 0.999),
            "whisper_base": (-1.0, 0.3)}


@pytest.mark.parametrize("arch", ZOO)
def test_loss_and_gradients_bf16(arch):
    """The default bf16.  Loss within 1e-2 relative (seen 1.5e-3 at most);
    EBOPs equal (they read only the widths, which stay float32); the
    gradients by ``COS_BF16``.  Zamba2's HGQ widths' gradients by cosine >=
    0.99 (seen 1.0).  Whisper's encoder widths' gradients are sums of
    rounding residuals with no EBOPs term (``encode`` discards its EBOPs),
    whose sign bf16 rounding decides (the reference's own bf16 and float32
    ones have a cosine of -0.9999), so its widths are held only by their
    median cosine >= 0.99 (seen 0.9997)."""
    (jl, jmet, jg), (tl, tmet, tg) = objectives(arch, "bfloat16")
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert float(tmet["ebops"]) == float(jmet["ebops"])
    cos = {k: cosine(g.float().numpy(), jg[k]) for k, g in tg.items()}
    plain = [v for k, v in cos.items() if "_q" not in k]
    widths = [v for k, v in cos.items() if "_q" in k]
    lo, med = COS_BF16[arch]
    assert min(plain) >= lo and float(np.median(plain)) >= med, cos
    if arch == "zamba2_12b":
        assert min(widths) >= 0.99, cos
    if arch == "whisper_base":
        assert float(np.median(widths)) >= 0.99, cos
        assert min(cos["dec_norm"], cos["dec_norm_b"]) >= 0.99, cos


def test_rwkv6_runs_no_quantizer():
    """RWKV-6's config asks for HGQ, but neither package's model quantizes:
    EBOPs 0, and no quantizer parameter exists."""
    (_, jmet, _), (_, tmet, tg) = objectives("rwkv6_16b", "float32")
    assert float(tmet["ebops"]) == float(jmet["ebops"]) == 0.0
    assert not any("_q" in k for k in tg) and tbase.get_config("rwkv6_16b").quant == "hgq"


@pytest.mark.parametrize("arch", ZOO)
def test_defs_and_param_counts_at_full_width(arch):
    """Every parameter's path and shape, and the count, at the published
    widths (nothing is allocated); the port's class draws them without
    being built."""
    jm = jbuild(jbase.get_config(arch))
    cfg = tbase.get_config(arch)
    tdefs = flat_defs(model_class(cfg).defs_of(cfg))
    jdefs = {"/".join(str(getattr(k, "key", k)) for k in kp): d.shape for kp, d in
             jax.tree_util.tree_flatten_with_path(
                 jm.defs(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {k: d.shape for k, d in tdefs.items()} == jdefs
    assert count_params({"all": tdefs}) == jcount(jm.defs())


@pytest.mark.parametrize("arch", ZOO)
def test_input_specs_and_cache_defs(arch):
    jm, _, tm = pair(arch)
    for mode in ("train", "prefill", "decode"):
        js, ts = jm.input_specs(16, 2, mode), tm.input_specs(16, 2, mode)
        assert {k: tuple(v.shape) for k, v in js.items()} == {k: v.shape for k, v in ts.items()}
        for k, v in js.items():
            assert str(v.dtype) == str(ts[k].dtype).replace("torch.", ""), (k, v.dtype)
    jc, tc = jm.cache_defs(2, 40), tm.cache_defs(2, 40)
    assert {k: (d.shape, np.dtype(d.dtype).name) for k, d in jc.items()} == \
        {k: (d.shape, str(d.dtype).replace("torch.", "")) for k, d in tc.items()}
