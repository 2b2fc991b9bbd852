"""Train, prefill and decode steps (port of ``repro.train.steps``).

``make_train_step(model, hp)`` builds the LM objective ``CE + β(step)·EBOPs
+ moe_aux_coef·aux`` of any model of the zoo (``DecoderLM``,
``ZambaHybrid``, ``RWKV6LM``, ``WhisperEncDec``: it calls only
``model.loss``), takes its gradients, clips and
Adam-updates the model's parameters in place (the reference's order: β at
the step before the increment, the learning rate at the step after it);
``make_prefill`` and ``make_decode_step`` wrap the serving forwards, and
``init_state`` gives the Adam state.

On a mesh (``mesh=``, a ``DeviceMesh``; the model built with the same mesh)
the parameters, Adam's moments and step, the batch and the caches are
DTensors under the placements of ``batch_shardings`` / ``param_shardings``
/ ``opt_shardings`` / ``cache_shardings`` (the reference's ``*_shardings``,
as DTensor placements keyed by path): ``init_state`` places the parameters
and the Adam state, the step functions place the parameters (the serving
profile for prefill and decode) and shard a plain batch over the DP axes,
and every step runs with tensors made inside the forward counted as
replicated (``sharding.mesh_context``).  Adam runs on the DTensors
unchanged.  Kernel B1 runs on each rank's local shard, so a step launches
it as often as without a mesh.

``make_lut_train_step(layers, hp)`` builds the β-regularised HGQ-LUT
objective ``CE + β(step)·EBOPs (+ λ·aux)``, takes its gradients, clips and
Adam-updates the layers' parameters, then writes the batch-norm moving stats
(the reference's order: β at the step before the increment, the learning
rate at the step after it, BN stats after Adam).

With ``hp.lut_use_fused`` every layer runs through the fused pair (kernel B2
forward, kernel B3 backward); a batch-norm layer's batch statistics come
from their own kernel pair first and are folded into B2's output
projection (``core/lut_layers.py``).  Only a batch-norm layer the fused
pair does not cover (more hidden layers, relu, other quantizers) takes the
einsum path and its two fake-quantizers (kernel B1 on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.ebops import BetaSchedule
from repro_torch.nn.base import merge_aux, scoped_updates
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.parallel import sharding as shd


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


# --------------------------------------------------------------- shardings
def batch_shardings(model, seq: int, batch: int, mode: str, mesh):
    """Placements of each model input: dim 0 over the DP axes that divide it."""
    return {k: shd.placements((shd.batch_dim_spec(v.shape[0], mesh),)
                              + (None,) * (len(v.shape) - 1), mesh, v.shape)
            for k, v in model.input_specs(seq, batch, mode).items()}


def param_shardings(model, mesh, serve: bool = False):
    """Placements of each parameter by path; ``serve`` takes the config's
    serving profile (``serve_fsdp``) where it sets one."""
    fsdp = model.cfg.fsdp
    if serve and model.cfg.serve_fsdp >= 0:
        fsdp = bool(model.cfg.serve_fsdp)
    return shd.flat_placements(model.defs(), mesh, fsdp=fsdp)


def opt_shardings(model, mesh):
    ps = param_shardings(model, mesh)
    return {"m": ps, "v": ps, "step": shd.placements((), mesh)}


def cache_shardings(model, batch: int, t: int, mesh):
    return shd.flat_placements(model.cache_defs(batch, t), mesh, fsdp=model.cfg.fsdp)


def _check_mesh(model, mesh) -> None:
    if mesh is not None and model.mesh is not mesh:
        raise ValueError("the model was built on another mesh: build_model(cfg, mesh)")


def place_params(model, shardings) -> None:
    """Make each parameter of ``model`` a DTensor under its placements in
    ``shardings`` (by path): a plain one is distributed (each rank keeps its
    slice), a DTensor redistributed; one already so placed is kept."""
    from torch.distributed.tensor import DTensor

    mesh = model.mesh
    for path, place in shardings.items():
        p = model.get_parameter(path)
        if isinstance(p, DTensor):
            if list(p.placements) == list(place):
                continue
            new = p.detach().redistribute(mesh, place)
        else:
            new = shd.distribute(p.detach(), mesh, place)
        model.register_parameter(path, torch.nn.Parameter(new, requires_grad=p.requires_grad))


def _shard_inputs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A batch's plain tensors sharded over the DP axes (DTensors kept)."""
    from torch.distributed.tensor import DTensor

    return {k: v if isinstance(v, DTensor) else shd.shard_batch(v, mesh)
            for k, v in batch.items()}


def _full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


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


def make_train_step(model, hp: TrainHParams = TrainHParams(), mesh=None):
    """Returns ``(step_fn, shardings)``: ``shardings`` is None without a
    mesh, else ``{"params", "opt"}`` (:func:`param_shardings`,
    :func:`opt_shardings`), as the reference's.

    ``step_fn(opt_state, batch)`` with ``batch = {"tokens", "labels"}`` (and
    ``patch_embeds`` for a VLM, ``frames`` for Whisper), tensors on the
    model's device, updates the
    model's parameters in place and returns ``(opt_state, metrics)``: loss,
    ce, ebops, aux_loss, grad_norm and lr as float32 tensors (nothing waits
    for the device).  With ``commit=False`` the step runs whole and writes
    nothing back (the chunked loop's warm-up before a capture).  Adam runs
    over the reference's paths, so its weight-decay mask is the same.

    On a mesh the model's parameters are placed (as :func:`init_state`
    does; ``opt_state`` comes from ``init_state(model, mesh)``), a plain
    batch is sharded over the DP axes, and the metrics come back whole.
    """
    _check_mesh(model, mesh)
    shardings = None
    if mesh is not None:
        shardings = {"params": param_shardings(model, mesh),
                     "opt": opt_shardings(model, mesh)}
        place_params(model, shardings["params"])

    def step_fn(opt_state, batch, commit: bool = True):
        if mesh is not None:
            batch = _shard_inputs(batch, mesh)
        with shd.mesh_context(mesh):
            loss, metrics, grads = lm_loss_and_grads(model, hp, opt_state["step"], batch)
            params = model.flat_params()
            new_p, opt_state, om = adam_update(
                {k: p.detach() for k, p in params.items()}, grads, opt_state,
                hp.adam, hp.lr_schedule)
            if mesh is not None:
                opt_state = _replace_like(opt_state, shardings["opt"], mesh)
                new_p = _replace_like(new_p, shardings["params"], mesh)
            if commit:
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(new_p[k])
        metrics = {**metrics, **om, "loss": loss}
        if mesh is not None:
            metrics = {k: _full(v) for k, v in metrics.items()}
        return opt_state, metrics

    return step_fn, shardings


def _replace_like(tree, shardings, mesh):
    """``tree``'s DTensors redistributed to ``shardings`` (same nesting)
    where a step left them otherwise (a gradient's pending sum, say)."""
    if isinstance(tree, dict):
        return {k: _replace_like(v, shardings[k], mesh) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    if not isinstance(tree, DTensor):
        return shd.distribute(tree, mesh, shardings)
    if list(tree.placements) != list(shardings):
        return tree.redistribute(mesh, shardings)
    return tree


def init_state(model, mesh=None):
    """``(params, opt_state)``: the model's parameters by path (the tensors a
    step trains in place; the model draws them when it is built) and their
    zero Adam state on the model's device.  On a mesh the parameters become
    DTensors under :func:`param_shardings` and Adam's ``m``/``v``/``step``
    under :func:`opt_shardings`."""
    _check_mesh(model, mesh)
    if mesh is not None:
        place_params(model, param_shardings(model, mesh))
    params = model.flat_params()
    opt = adam_init({k: p.detach() for k, p in params.items()})
    if mesh is not None:
        opt = _replace_like(opt, opt_shardings(model, mesh), mesh)
    return params, opt


def make_prefill(model, mesh=None):
    """``prefill(batch, cache_len=None) -> (logits, cache)`` without autograd.

    On a mesh the parameters are placed under the serving profile, a plain
    batch is sharded over the DP axes and the logits and cache are
    DTensors."""
    _check_mesh(model, mesh)
    if mesh is not None:
        place_params(model, param_shardings(model, mesh, serve=True))

    @torch.no_grad()
    def prefill(batch, cache_len: Optional[int] = None):
        if mesh is None:
            return model.prefill(batch, cache_len=cache_len)
        with shd.mesh_context(mesh):
            return model.prefill(_shard_inputs(batch, mesh), cache_len=cache_len)

    return prefill


def make_decode_step(model, batch: Optional[int] = None, t: Optional[int] = None,
                     mesh=None):
    """``decode(cache, tokens) -> (logits, cache)`` without autograd; the
    cache's K/V are updated in place (the reference donates them).

    On a mesh (``batch`` and ``t``, the cache's batch and length, then
    given) the parameters are placed under the serving profile, the cache
    is kept under :func:`cache_shardings` and plain tokens are sharded over
    the DP axes."""
    _check_mesh(model, mesh)
    if mesh is None:
        @torch.no_grad()
        def decode(cache, tokens):
            return model.decode_step(cache, tokens)

        return decode
    if batch is None or t is None:
        raise ValueError("make_decode_step on a mesh needs the cache's batch and t")
    place_params(model, param_shardings(model, mesh, serve=True))
    cs = cache_shardings(model, batch, t, mesh)

    @torch.no_grad()
    def decode_mesh(cache, tokens):
        cache = _replace_like(cache, cs, mesh)
        tokens = _shard_inputs({"tokens": tokens}, mesh)["tokens"]
        with shd.mesh_context(mesh):
            return model.decode_step(cache, tokens)

    return decode_mesh


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
