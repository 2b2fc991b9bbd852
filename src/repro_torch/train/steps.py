"""Train, prefill and decode steps (port of ``repro.train.steps``).

``make_train_step(model, hp)`` builds the LM objective ``CE + β(step)·EBOPs
+ moe_aux_coef·aux`` of any model of the zoo (``DecoderLM``,
``ZambaHybrid``, ``RWKV6LM``, ``WhisperEncDec``: it calls only
``model.loss``), takes its gradients, clips and
Adam-updates the model's parameters in place (the reference's order: β at
the step before the increment, the learning rate at the step after it);
``make_prefill`` and ``make_decode_step`` wrap the serving forwards, and
``init_state`` gives the Adam state.  The reference's ``*_shardings``
functions wait for the mesh slice (ROADMAP A9c).

``make_lut_train_step(layers, hp)`` builds the β-regularised HGQ-LUT
objective ``CE + β(step)·EBOPs (+ λ·aux)``, takes its gradients, clips and
Adam-updates the layers' parameters, then writes the batch-norm moving stats
(the reference's order: β at the step before the increment, the learning
rate at the step after it, BN stats after Adam).

With ``hp.lut_use_fused`` every layer runs through the fused pair (kernel B2
forward, kernel B3 backward), except a batch-norm layer in train mode, which
takes the einsum path and its two fake-quantizers (kernel B1 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.ebops import BetaSchedule
from repro_torch.nn.base import merge_aux, scoped_updates
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    adam: AdamConfig = AdamConfig()
    beta: BetaSchedule = BetaSchedule(beta_init=0.0, beta_final=None)
    moe_aux_coef: float = 0.01
    lr_schedule: Optional[Callable] = None
    # route LUT layers through the fused kernel pair (kernels/ops.lut_dense)
    lut_use_fused: bool = False


def hparams_from_cfg(cfg, **overrides) -> TrainHParams:
    """Seed :class:`TrainHParams` from an ``ArchConfig`` (``lut_use_fused``
    and its ``REPRO_LUT_USE_FUSED`` override reach the train step)."""
    overrides.setdefault("lut_use_fused", getattr(cfg, "lut_use_fused", False))
    return TrainHParams(**overrides)


# -------------------------------------------------------------- LM steps
def _full_grads(total, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    got = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), got)}


def lm_loss_and_grads(model, hp: TrainHParams, step, batch):
    """The LM objective at ``step`` and its gradients, keyed by reference
    path (``blocks/w_gate``).  Returns ``(loss, metrics, grads)``."""
    params = model.flat_params()
    ce, metrics = model.loss(batch)
    total = (ce + hp.beta(step) * metrics["ebops"]
             + hp.moe_aux_coef * metrics["aux_loss"])
    grads = _full_grads(total, params)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, hp: TrainHParams = TrainHParams()):
    """Returns ``(step_fn, None)`` (the reference's ``(step_fn, shardings)``
    with no mesh).

    ``step_fn(opt_state, batch)`` with ``batch = {"tokens", "labels"}`` (and
    ``patch_embeds`` for a VLM, ``frames`` for Whisper), tensors on the
    model's device, updates the
    model's parameters in place and returns ``(opt_state, metrics)``: loss,
    ce, ebops, aux_loss, grad_norm and lr as float32 tensors (nothing waits
    for the device).  With ``commit=False`` the step runs whole and writes
    nothing back (the chunked loop's warm-up before a capture).  Adam runs
    over the reference's paths, so its weight-decay mask is the same.
    """

    def step_fn(opt_state, batch, commit: bool = True):
        loss, metrics, grads = lm_loss_and_grads(model, hp, opt_state["step"], batch)
        params = model.flat_params()
        new_p, opt_state, om = adam_update(
            {k: p.detach() for k, p in params.items()}, grads, opt_state,
            hp.adam, hp.lr_schedule)
        if commit:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(new_p[k])
        return opt_state, {**metrics, **om, "loss": loss}

    return step_fn, None


def init_state(model):
    """``(params, opt_state)``: the model's parameters by path (the tensors a
    step trains in place; the model draws them when it is built) and their
    zero Adam state on the model's device."""
    params = model.flat_params()
    return params, adam_init({k: p.detach() for k, p in params.items()})


def make_prefill(model):
    """``prefill(batch, cache_len=None) -> (logits, cache)`` without autograd."""

    @torch.no_grad()
    def prefill(batch, cache_len: Optional[int] = None):
        return model.prefill(batch, cache_len=cache_len)

    return prefill


def make_decode_step(model):
    """``decode(cache, tokens) -> (logits, cache)`` without autograd; the
    cache's K/V are updated in place (the reference donates them)."""

    @torch.no_grad()
    def decode(cache, tokens):
        return model.decode_step(cache, tokens)

    return decode


# ------------------------------------------------------ LUT-stack train step
def named_params(layers: Sequence[torch.nn.Module]) -> Dict[str, torch.Tensor]:
    """The stack's trainable parameters keyed by reference path (``l0/q_in/f``)."""
    return {f"l{k}/{name.replace('.', '/')}": p
            for k, layer in enumerate(layers) for name, p in layer.named_parameters()}


def lut_loss_and_grads(layers, hp: TrainHParams, step, batch):
    """Forward in train mode and backward of the objective at ``step``.

    Returns ``(loss, ce, aux, grads)``; ``grads`` is keyed like
    :func:`named_params`.
    """
    params = named_params(layers)
    h = batch["x"]
    auxes = []
    for idx, layer in enumerate(layers):
        layer.train(True)
        h, a = layer(h, fused=True if hp.lut_use_fused else None)
        auxes.append(scoped_updates(f"l{idx}", a))
    aux = merge_aux(*auxes)
    logp = torch.log_softmax(h, dim=-1)
    ce = -torch.mean(logp.gather(-1, batch["y"].long()[:, None])[:, 0])
    total = ce + hp.beta(step) * aux.ebops + hp.moe_aux_coef * aux.aux_loss
    return total.detach(), ce.detach(), aux, _full_grads(total, params)


def make_lut_train_step(layers: Sequence[torch.nn.Module],
                        hp: TrainHParams = TrainHParams()):
    """CE + β·EBOPs train step over a stack of LUT layers.

    Returns ``(step_fn, init_fn)``.  ``init_fn()`` gives the Adam state of
    the layers' current parameters (the layers are built, and seeded, by the
    caller); ``step_fn(opt_state, batch)`` with ``batch = {"x", "y"}``
    updates the layers in place and returns ``(opt_state, metrics)``, the
    metrics as tensors (nothing waits for the device).  With ``commit=False``
    the step runs whole and writes nothing back: the chunked loop's warm-up
    before a CUDA-graph capture (``train/loop.py``).  With
    ``hp.lut_use_fused`` every layer trains on the fused path; the layers'
    own ``use_fused`` (their eval path) is left as it is.  The layers stay
    in train mode after a step.
    """

    def step_fn(opt_state, batch, commit: bool = True):
        loss, ce, aux, grads = lut_loss_and_grads(layers, hp, opt_state["step"], batch)
        params = named_params(layers)
        new_p, opt_state, om = adam_update(
            {k: p.detach() for k, p in params.items()}, grads, opt_state,
            hp.adam, hp.lr_schedule)
        if commit:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(new_p[k])
                for path, val in aux.updates.items():       # BN moving stats
                    scope, key = path.split("/", 1)
                    getattr(layers[int(scope[1:])], key).copy_(val)
        metrics = {"loss": loss, "ce": ce, "ebops": aux.ebops.detach(), **om}
        return opt_state, metrics

    def init_fn():
        return adam_init({k: p.detach() for k, p in named_params(layers).items()})

    return step_fn, init_fn
