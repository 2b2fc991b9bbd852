"""``DecoderLM`` (``repro_torch.models.lm``) against the reference's, per arch.

The seven decoder configs' smoke reductions (qk-norm, QKV bias, sliding
windows, MoE with and without a dense residual, VLM patch embeddings, HGQ
quantizers) run through both packages on the same numpy parameters (the
reference's init, crossed with ``interop.lm_params_from_numpy``) and the
same batch.  Float32 holds the algorithm to tight bounds; the bf16 default
to loose ones, with reasons at each bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models.registry import build_model as jbuild
from repro.nn.params import count_params as jcount
from repro.nn.params import init_params as jinit
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.models.registry import build_model
from repro_torch.nn.params import count_params, flat_defs

torch.set_num_threads(2)

DECODER_ARCHS = ["olmo_1b", "qwen3_14b", "gemma3_12b", "qwen15_05b", "phi35_moe",
                 "arctic_480b", "internvl2_26b"]
BETA = 1e-7          # weight of EBOPs in the objective, so their gradients count
AUX = 0.01           # the default moe_aux_coef


def pair(arch, dtype="bfloat16", seed=0, **over):
    """(reference model, its params, port model with the same params)."""
    jcfg = dataclasses.replace(jbase.get_smoke(arch), dtype=dtype, **over)
    tcfg = dataclasses.replace(tbase.get_smoke(arch), dtype=dtype, **over)
    jm = jbuild(jcfg)
    params = jinit(jm.defs(), jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    interop.lm_params_from_numpy(tm, jax.tree.map(np.array, params))
    return jm, params, tm


def batch(model_cfg, b, s, mode="train", seed=0):
    """The same batch as numpy, for both packages: tokens (and labels),
    patch embeddings of a VLM as bf16 values."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, 50, (b, s)).astype(np.int32)}
    if mode == "train":
        out["labels"] = rng.integers(1, 50, (b, s)).astype(np.int32)
    if model_cfg.family == "vlm" and mode != "decode":
        pe = rng.normal(0, 1, (b, model_cfg.n_patches, model_cfg.d_model)).astype(np.float32)
        out["patch_embeds"] = np.asarray(jnp.asarray(pe, jnp.bfloat16).astype(jnp.float32))
    return out


def jbatch(nb):
    return {k: jnp.asarray(v, jnp.bfloat16) if k == "patch_embeds" else jnp.asarray(v)
            for k, v in nb.items()}


def tbatch(nb, device="cpu"):
    return {k: torch.as_tensor(v, device=device).to(torch.bfloat16) if k == "patch_embeds"
            else torch.as_tensor(v, device=device) for k, v in nb.items()}


def ref_objective(jm, nb):
    def f(p):
        ce, m = jm.loss(p, jbatch(nb))
        return ce + BETA * m["ebops"] + AUX * m["aux_loss"], m
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def port_objective(tm, nb):
    ce, m = tm.loss(tbatch(nb, tm.device))
    total = ce + BETA * m["ebops"] + AUX * m["aux_loss"]
    params = tm.flat_params()
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), {k: v.detach() for k, v in m.items()}, dict(zip(params, grads))


def cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-300))


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_and_gradients_float32(arch):
    """Loss and metrics within 1e-5 relative.  Gradients: every tensor
    within 1e-3 of its largest entry.  That is not rounding alone: the
    smoke configs are ill-conditioned, and the reference's own float32
    gradients move by up to 1.2e-4 of their largest entry (gemma3) when its
    parameters move by 1e-7 relative.  The HGQ width parameters (``_q``),
    sums of rounding residuals whose codes can flip between the two
    packages, within 1e-2 of their largest and with cosine >= 0.999."""
    jm, params, tm = pair(arch, "float32")
    nb = batch(tm.cfg, 2, 32)
    (jl, jmet), jg = ref_objective(jm, nb)(params)
    tl, tmet, tg = port_objective(tm, nb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("ce", "ebops", "aux_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    jgf = interop.unnest(jax.tree.map(np.asarray, jg))
    assert set(jgf) == set(tg)
    for k, g in tg.items():
        want, got = jgf[k], g.numpy()
        scale = float(np.abs(want).max()) + 1e-30
        err = float(np.abs(got - want).max()) / scale
        if "_q" in k:
            assert err <= 1e-2 and cosine(got, want) >= 0.999, (k, err)
        else:
            assert err <= 1e-3, (k, err)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_loss_and_gradients_bf16(arch):
    """The default bf16 working copy.  Loss within 1e-2 relative; EBOPs
    equal (they read only the widths, which stay float32).  The two
    frameworks round bf16 at other places (XLA keeps float32 inside its
    fusions, torch rounds after every op), so each gradient tensor is held
    by its direction: cosine >= 0.98 with the reference's, and >= 0.99 for
    the median tensor (the lowest seen 0.997).  gemma3's smoke config, four
    layers whose float32 gradients already move by 1.2e-4 of their largest
    under a 1e-7 relative change of the parameters, amplifies the rounding
    differences: >= 0.75 and a median >= 0.85 there (seen 0.85 and 0.91).
    The HGQ width parameters sum rounding residuals over codes that flip
    where bf16 rounding moved an input across a boundary: >= 0.95 (seen
    0.977)."""
    jm, params, tm = pair(arch, "bfloat16")
    nb = batch(tm.cfg, 2, 32)
    (jl, jmet), jg = ref_objective(jm, nb)(params)
    tl, tmet, tg = port_objective(tm, nb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    assert float(tmet["ebops"]) == float(jmet["ebops"])
    jgf = interop.unnest(jax.tree.map(np.asarray, jg))
    cos = {k: cosine(g.float().numpy(), jgf[k]) for k, g in tg.items()}
    lo, med = (0.75, 0.85) if arch == "gemma3_12b" else (0.98, 0.99)
    assert min(v for k, v in cos.items() if "_q" not in k) >= lo, cos
    assert min((v for k, v in cos.items() if "_q" in k), default=1.0) >= 0.95, cos
    assert float(np.median(list(cos.values()))) >= med, cos


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_defs_and_param_counts_at_full_width(arch):
    """Every parameter's path and shape, and the count, at the published
    widths (nothing is allocated)."""
    from repro_torch.models.lm import lm_defs

    jm = jbuild(jbase.get_config(arch))
    tdefs = flat_defs(lm_defs(tbase.get_config(arch)))
    jdefs = {"/".join(str(getattr(k, "key", k)) for k in kp): d.shape for kp, d in
             jax.tree_util.tree_flatten_with_path(
                 jm.defs(), is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert {k: d.shape for k, d in tdefs.items()} == jdefs
    assert count_params({"all": tdefs}) == jcount(jm.defs())


def test_layer_windows_and_input_specs():
    for arch in DECODER_ARCHS:
        jm, _, tm = pair(arch)
        np.testing.assert_array_equal(tm.layer_windows().numpy(), np.asarray(jm.layer_windows()))
        for mode in ("train", "prefill", "decode"):
            js = jm.input_specs(16, 2, mode)
            ts = tm.input_specs(16, 2, mode)
            assert {k: tuple(v.shape) for k, v in js.items()} == {k: v.shape for k, v in ts.items()}


def test_vlm_patch_embeds_change_output_and_moe_aux():
    _, _, tm = pair("internvl2_26b")
    nb = batch(tm.cfg, 2, 16)
    l1, _ = tm.loss(tbatch(nb))
    nb2 = dict(nb, patch_embeds=nb["patch_embeds"] + 1.0)
    l2, _ = tm.loss(tbatch(nb2))
    assert float(l1) != float(l2)
    _, _, moe = pair("phi35_moe")
    _, m = moe.loss(tbatch(batch(moe.cfg, 2, 32)))
    assert float(m["aux_loss"]) > 0


def test_remat_changes_no_value():
    """Per-layer and per-chunk checkpoints recompute the same ops: loss and
    gradients equal bit for bit with and without them."""
    _, _, a = pair("olmo_1b", "float32")
    _, _, b = pair("olmo_1b", "float32", remat=False, flash_remat=False, ce_remat=False)
    nb = batch(a.cfg, 2, 32)
    la, _, ga = port_objective(a, nb)
    lb, _, gb = port_objective(b, nb)
    assert float(la) == float(lb)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k
