"""Decoder-only LM: the lm / moe / vlm families of the zoo (port of
``repro.models.lm``).

``DecoderLM`` is an ``nn.Module`` whose parameters keep the reference's
paths and shapes: ``embed``, ``blocks/wq`` (L, d, N, hd), ...,
``blocks/gate_qwf`` (L,), ``final_norm``, ``head``.  The block parameters
stay *stacked* over layers and the forward loops over the layers, indexing
the stacks (the reference's ``lax.scan``); the parameters cross packages as
the reference's nested numpy dict (``interop.lm_params_*``).

* **Mixed precision** (``dtype="bfloat16"``): the train forward runs on a
  bf16 working copy of the stacks (``_working_blocks``), except the HGQ
  bit-width parameters (names with ``_q``), which stay float32; prefill and
  decode cast each weight where it is used, as the reference does.  The
  embedding scale is rounded to the compute dtype before the multiply, the
  CE logits come from a bf16 product widened to float32, the serving
  logits from a float32 product on float32 weights.
* **Memory**: ``remat`` checkpoints each layer (``torch.utils.checkpoint``,
  so its forward runs again in the backward), attention is q-chunked
  (``nn/attention.py``) and the cross-entropy head runs over sequence
  chunks of ``LOSS_CHUNK`` tokens, each checkpointed with ``ce_remat``, so
  the (B, S, V) logits never exist.  The gold logit is a gather, the
  reference's one-hot dot product without the (B, c, V) one-hot.
* **Serving**: ``prefill`` builds the (L, B, K, T, hd) caches from the K/V
  each layer's attention computes (the reference recomputes them with the
  same ops on the same inputs, so the bits are the same) and can allocate
  them at a longer ``cache_len`` at once (the launcher's grown cache);
  ``decode_step`` writes each layer's row into them in place.

* **Mesh** (``mesh=``, a ``DeviceMesh``): the parameters become DTensors
  when ``train/steps.py`` places them (``init_state``, ``make_prefill``),
  and the reference's sharding constraints run at its sites as
  ``parallel/sharding.constrain``: the residual stream after each block
  over (batch, -, -), the CE chunk's logits over (batch, -, model), MoE's
  dispatch tensors, and K/V over their sequence when the head count does
  not divide the ``model`` axis (``attn_sp``, SP attention).  Tensors
  made inside the forward (positions, zeros) count as replicated
  (``sharding.mesh_context``).  With ``mesh=None`` nothing of this runs.

What the zoo's model classes share lives here too: ``ZooModel`` (the
parameters registered by reference path from the class's ``defs_of(cfg)``,
``flat_params``, the stacks by prefix), the chunked CE head ``ce_loss``,
``_ckpt`` and ``TensorSpec``; ``lm_checkpoint_shapes`` takes a config of
any family.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlpm
from repro_torch.nn import moe as moem
from repro_torch.nn.layers import (activation_fn, apply_norm, embed_lookup,
                                   layer_norm, norm_defs, rms_norm)
from repro_torch.nn.params import PDef, flat_defs, init_tensor
from repro_torch.parallel import sharding as shd

LOSS_CHUNK = 256  # sequence chunk for the CE head

Tensor = torch.Tensor


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (the reference's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _ckpt(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint when autograd records
    (the model has no randomness, so no RNG state is kept)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def lm_defs(cfg: ArchConfig) -> Dict[str, object]:
    """The nested PDef dict of a decoder LM (the reference's ``DecoderLM.defs``)."""
    L, d = cfg.n_layers, cfg.d_model
    blocks: Dict[str, object] = {}
    blocks.update(attn.attn_defs(L, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                 cfg.qk_norm, cfg.qkv_bias))
    if cfg.n_experts:
        blocks.update(moem.moe_defs(L, d, cfg.d_ff, cfg.n_experts))
        if cfg.dense_residual:
            dr = mlpm.glu_defs(L, d, cfg.d_ff, cfg.quant)
            blocks.update({f"dr_{k}": v for k, v in dr.items()})
    elif cfg.mlp_type == "glu":
        blocks.update(mlpm.glu_defs(L, d, cfg.d_ff, cfg.quant))
    else:
        blocks.update(mlpm.mlp_defs(L, d, cfg.d_ff, cfg.quant))
    blocks.update(norm_defs(L, d, cfg.norm_type, cfg.nonparam_norm))

    defs: Dict[str, object] = {
        "embed": PDef((cfg.vocab, d), ("vocab", "embed")),
        "blocks": blocks,
    }
    if not cfg.nonparam_norm:
        defs["final_norm"] = PDef((d,), (None,), init="zeros")
    if not cfg.tie_embeddings:
        defs["head"] = PDef((d, cfg.vocab), ("embed", "vocab"))
    return defs


def lm_checkpoint_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    """Every array of an LM checkpoint with its shape, from the config alone
    (any family of the zoo: the defs come from its model class, which is not
    built): ``params/<path>``, ``opt/m/<path>``, ``opt/v/<path>`` and
    ``opt/step``, the names the reference's ``tree_flatten_with_path`` gives
    them."""
    from repro_torch.models.registry import model_class

    defs = flat_defs(model_class(cfg).defs_of(cfg))
    out = {f"{head}/{k}": tuple(d.shape) for head in ("params", "opt/m", "opt/v")
           for k, d in defs.items()}
    out["opt/step"] = ()
    return out


def ce_loss(x: Tensor, w: Tensor, labels: Tensor, remat: bool, mesh=None) -> Tensor:
    """Mean cross-entropy of the logits ``x @ w`` against ``labels`` over
    sequence chunks of ``LOSS_CHUNK`` tokens (each checkpointed with
    ``remat``): the logits are a product in x's dtype widened to float32
    (on a mesh constrained to (batch, -, model)), and the gold logit a
    gather."""
    labels = labels.long()
    b, s, _ = x.shape
    c = min(LOSS_CHUNK, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the CE chunk {c}")

    def ce_chunk(xk, lk):
        logits = shd.constrain(torch.matmul(xk, w).float(), mesh, "batch", None, "model")
        lse = torch.logsumexp(logits, dim=-1)
        if shd.is_sharded(logits, -1):
            # a gather cannot index a sharded vocab: the reference's masked
            # sum, each rank over its slice (ROADMAP C18)
            hit = lk[..., None] == torch.arange(logits.shape[-1], device=lk.device)
            gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
        else:
            gold = torch.gather(logits, -1, lk[..., None])[..., 0]
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(s // c):
        args = (x[:, j * c:(j + 1) * c], labels[:, j * c:(j + 1) * c])
        total = total + (_ckpt(ce_chunk, *args) if remat else ce_chunk(*args))
    return total / (b * s)


def model_device(device=None, mesh=None) -> torch.device:
    """Where a zoo model is built: ``device``, else the device type of
    ``mesh``, else the card.  Asked for ``cuda`` with no card it raises;
    nothing falls back to the CPU, which a caller asks for by name."""
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the model on the CPU")
    return device


class ZooModel(nn.Module):
    """What the zoo's model classes share: the parameters of
    ``defs_of(cfg)`` registered by reference path (``blocks/wq``) and drawn
    from ``generator`` on ``model_device(device, mesh)`` (``nn/params.py``'s
    distributions), the compute dtype, and the stacked parameters by
    prefix."""

    def __init__(self, cfg: ArchConfig, mesh=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        device = model_device(device, mesh)
        for path, d in flat_defs(self.defs()).items():
            self.register_parameter(path, nn.Parameter(init_tensor(d, generator, device)))

    @staticmethod
    def defs_of(cfg: ArchConfig) -> Dict[str, object]:
        raise NotImplementedError

    def defs(self) -> Dict[str, object]:
        return self.defs_of(self.cfg)

    def flat_params(self) -> Dict[str, nn.Parameter]:
        """The parameters by reference path (``blocks/wq``), in defs order."""
        return dict(self.named_parameters())

    @property
    def device(self) -> torch.device:
        return self.get_parameter("embed").device

    def _lookup(self, tokens: Tensor) -> Tensor:
        """The embeddings of ``tokens`` in the compute dtype; on a mesh
        looked up by ``sharding.gather_rows`` and constrained to (batch, -,
        -), so no pending reduction or sharded feature dim reaches the
        first norm (C18)."""
        table = self.get_parameter("embed")
        if self.mesh is None:
            return embed_lookup(table, tokens, self.compute_dtype)
        x = shd.gather_rows(table, tokens.long()).to(self.compute_dtype)
        return self._constrain(x, "batch", None, None)

    def _constrain(self, x: Tensor, *axes) -> Tensor:
        return shd.constrain(x, self.mesh, *axes)

    def _rows(self, h: Tensor) -> Tensor:
        """A norm's output on its way into a block's projections: on a mesh
        made whole along ``model`` (its pending sum reduced, the Megatron
        all-reduce), so DTensor does not gather the weights instead (C18)."""
        return self._constrain(h, "batch", None, None)

    def _constrain_fn(self):
        """``constrain`` bound to the model's mesh, or None without one."""
        if self.mesh is None:
            return None
        return lambda t, *ax: shd.constrain(t, self.mesh, *ax)

    def _stack(self, prefix: str) -> Dict[str, Tensor]:
        """The parameters under ``prefix/`` by their key below it."""
        n = len(prefix) + 1
        return {k[n:]: v for k, v in self.named_parameters() if k.startswith(prefix + "/")}

    @staticmethod
    def _layer(blocks: Dict[str, Tensor], l: int) -> Dict[str, Tensor]:
        return {k: v[l] for k, v in blocks.items()}

    def _positions(self, b: int, s: int) -> Tensor:
        return torch.arange(s, device=self.device).expand(b, s)

    def _index(self, s: int) -> Tensor:
        return torch.full((), s, dtype=torch.int32, device=self.device)

    def _zero_cache(self, b: int, t: int) -> Dict[str, Tensor]:
        """``cache_defs(b, t)`` materialised as zeros on the model's device
        (on a mesh as DTensors under the cache's sharding rules)."""
        defs = self.cache_defs(b, t)
        place = (shd.flat_placements(defs, self.mesh, self.cfg.fsdp)
                 if self.mesh is not None else {})
        return {k: shd.zeros(d.shape, d.dtype, self.device, self.mesh, place.get(k))
                for k, d in defs.items()}

    @staticmethod
    def _serve_logits(x_last: Tensor, w: Tensor) -> Tensor:
        """Serving logits: a float32 product on float32 weights."""
        return torch.matmul(x_last.float(), w.float())


class DecoderLM(ZooModel):
    """The decoder LM of ``cfg`` with parameters drawn from ``generator``
    (``nn/params.py``'s distributions) on ``device`` (``model_device``)."""

    def __init__(self, cfg: ArchConfig, mesh=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, mesh, device=device, generator=generator)
        self.attn_cfg = attn.AttnCfg(
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
            rope_theta=cfg.rope_theta, causal=True, q_chunk=cfg.q_chunk,
            remat_chunks=cfg.flash_remat)
        # SP attention when the head count doesn't divide the model axis
        self.attn_sp = mesh is not None and not shd.heads_shardable(cfg.n_heads, mesh)
        self._windows = self._layer_window_list()

    # ------------------------------------------------------------------ defs
    @staticmethod
    def defs_of(cfg: ArchConfig) -> Dict[str, object]:
        return lm_defs(cfg)

    def _layer_window_list(self):
        cfg = self.cfg
        if cfg.global_period:
            return [attn.NO_WINDOW if (l + 1) % cfg.global_period == 0 else cfg.window
                    for l in range(cfg.n_layers)]
        return [cfg.window if cfg.window else attn.NO_WINDOW] * cfg.n_layers

    def layer_windows(self) -> Tensor:
        """Per-layer attention window (NO_WINDOW = global), int32."""
        return torch.tensor(self._windows, dtype=torch.int32)

    # --------------------------------------------------------------- blocks
    def _blocks(self) -> Dict[str, Tensor]:
        return self._stack("blocks")

    def _working_blocks(self) -> Dict[str, Tensor]:
        """Compute-dtype working copy of the stacked block params; the HGQ
        bit-width parameters (names with ``_q``) stay float32."""
        cd = self.compute_dtype
        blocks = self._blocks()
        if cd == torch.float32:
            return blocks
        return {k: v if "_q" in k or v.dtype != torch.float32 else v.to(cd)
                for k, v in blocks.items()}

    # ----------------------------------------------------------------- embed
    def _embed_inputs(self, batch: Dict[str, Tensor]) -> Tensor:
        cfg = self.cfg
        x = self._lookup(batch["tokens"])
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        return x

    def _final_norm(self, x: Tensor) -> Tensor:
        cfg = self.cfg
        if cfg.nonparam_norm:
            return x
        fn = self.get_parameter("final_norm")
        if cfg.norm_type == "rmsnorm":
            return rms_norm(x, fn)
        return layer_norm(x, 1.0 + fn, None)

    # ------------------------------------------------------------- lm blocks
    def _block(self, pl: dict, x: Tensor, window, positions, cache_kv=None,
               index=None, return_kv: bool = False):
        """One transformer block.  Returns (x, kv, ebops, aux): kv is the
        layer's own (K, V) with ``return_kv``, the updated caches with
        ``cache_kv``, else None."""
        cfg = self.cfg
        h = self._rows(apply_norm(pl, 0, x, cfg.norm_type, cfg.nonparam_norm))
        if cache_kv is None:
            kvc = self._constrain_fn() if self.attn_sp else None
            out = attn.multihead_attention(pl, h, self.attn_cfg, positions=positions,
                                           window=window, return_kv=return_kv,
                                           kv_constrain=kvc)
            a, kv = out if return_kv else (out, None)
        else:
            kc, vc = cache_kv
            a, kc, vc = attn.decode_attention(pl, h, self.attn_cfg, kc, vc, index,
                                              window=window)
            kv = (kc, vc)
        x = x + a
        h2 = self._rows(apply_norm(pl, 1, x, cfg.norm_type, cfg.nonparam_norm))
        eb = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.n_experts:
            m, aux = moem.moe_apply(pl, h2, activation_fn(cfg.act), top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor,
                                    constrain=self._constrain_fn())
            if cfg.dense_residual:
                drp = {k[3:]: v for k, v in pl.items() if k.startswith("dr_")}
                dr, eb = mlpm.glu_apply(drp, h2, cfg.act, cfg.quant)
                m = m + dr
        elif cfg.mlp_type == "glu":
            m, eb = mlpm.glu_apply(pl, h2, cfg.act, cfg.quant)
        else:
            m, eb = mlpm.mlp_apply(pl, h2, cfg.act, cfg.quant)
        return self._constrain(x + m, "batch", None, None), kv, eb, aux

    # ------------------------------------------------------------------ fwd
    def hidden_states(self, batch) -> Tuple[Tensor, Tensor, Tensor]:
        """Full-sequence forward -> (hidden (B,S,D), ebops, aux_loss)."""
        x = self._embed_inputs(batch)
        b, s = batch["tokens"].shape
        positions = self._positions(b, s)
        blocks = self._working_blocks()
        ebs, auxs = [], []
        for l, w in enumerate(self._windows):
            pl = self._layer(blocks, l)

            def body(x_in, pl=pl, w=w):
                y, _, eb, aux = self._block(pl, x_in, w, positions)
                return y, eb, aux

            x, eb, aux = _ckpt(body, x) if self.cfg.remat else body(x)
            ebs.append(eb)
            auxs.append(aux)
        x = self._final_norm(x)
        return x, torch.sum(torch.stack(ebs)), torch.sum(torch.stack(auxs))

    def _head_weight(self) -> Tensor:
        if self.cfg.tie_embeddings:
            return self.get_parameter("embed").T
        return self.get_parameter("head")

    def loss(self, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Chunked-CE training loss + metrics. batch: tokens, labels (B,S)."""
        x, ebops, aux = self.hidden_states(batch)
        w = self._head_weight().to(self.compute_dtype)
        ce = ce_loss(x, w, batch["labels"], self.cfg.ce_remat, self.mesh)
        return ce, {"ce": ce, "ebops": ebops, "aux_loss": aux}

    # ------------------------------------------------------------- serving
    def cache_defs(self, batch: int, t: int) -> Dict[str, object]:
        cfg = self.cfg
        cd = attn.cache_defs(cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hd,
                             dtype=self.compute_dtype)
        cd["index"] = PDef((), (), init="zeros", dtype=torch.int32)
        return cd

    def prefill(self, batch, cache_len: Optional[int] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Full-context forward that also materialises the KV cache.

        The caches are (L, B, K, T, hd) in the compute dtype with T =
        ``cache_len`` (default the prompt's length S); positions past S are
        zeros, as the reference's padded ("grown") caches."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        b, s = batch["tokens"].shape
        t = s if cache_len is None else cache_len
        if t < s:
            raise ValueError(f"cache_len {t} is shorter than the prompt {s}")
        positions = self._positions(b, s)
        blocks = self._blocks()
        cache = self._zero_cache(b, t)
        for l, w in enumerate(self._windows):
            x, (k, v), _, _ = self._block(self._layer(blocks, l), x, w, positions,
                                          return_kv=True)
            shd.assign(cache["k"], (l, slice(None), slice(None), slice(0, s)), k.transpose(1, 2))
            shd.assign(cache["v"], (l, slice(None), slice(None), slice(0, s)), v.transpose(1, 2))
        x = self._final_norm(x)
        cache["index"] = self._index(s)
        return self._serve_logits(x[:, -1], self._head_weight()), cache

    def decode_step(self, cache: Dict[str, Tensor], tokens: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One serve step: next-token logits + the cache. tokens (B,).

        Each layer's K/V row is written into ``cache["k"]`` / ``cache["v"]``
        in place; the returned dict holds those tensors and the index + 1."""
        cfg = self.cfg
        index = cache["index"]
        x = self._lookup(tokens[:, None])
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        blocks = self._blocks()
        for l, w in enumerate(self._windows):
            x, _, _, _ = self._block(self._layer(blocks, l), x, w, None,
                                     cache_kv=(cache["k"][l], cache["v"][l]),
                                     index=index)
        x = self._final_norm(x)
        return self._serve_logits(x[:, 0], self._head_weight()), {
            "k": cache["k"], "v": cache["v"], "index": index + 1}

    # --------------------------------------------------------------- inputs
    def input_specs(self, seq_len: int, batch: int, mode: str) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        tok = TensorSpec((batch, seq_len), torch.int32)
        if mode == "train":
            out = {"tokens": tok, "labels": tok}
        elif mode == "prefill":
            out = {"tokens": tok}
        else:  # decode
            out = {"tokens": TensorSpec((batch,), torch.int32)}
        if cfg.family == "vlm" and mode != "decode":
            out["patch_embeds"] = TensorSpec((batch, cfg.n_patches, cfg.d_model),
                                             torch.bfloat16)
        return out

