"""Zamba2-style hybrid: a Mamba2 (SSD) backbone and one *shared* attention +
GLU block (port of ``repro.models.zamba``).

Every ``attn_every``-th of the ``n_layers`` Mamba2 layers also applies the
single shared block (parameter reuse, Zamba's signature).  The parameters
keep the reference's paths and shapes: ``blocks/*`` stacked over layers,
``shared/*`` with a leading dim of 1.  Decode carries each layer's SSM and
conv states and one KV cache per shared-block *application* (n_app =
ceil(L / attn_every) slots).

Differences from the reference, each with the same values and gradients:

* the shared block runs only at the layers that apply it.  The reference
  computes it at every layer and selects it with ``where``, whose gradient
  to the unselected branch is zero; running it everywhere here would also
  write K/V rows into a cache slot at unflagged decode steps, since
  ``decode_attention`` writes in place;
* ``prefill`` writes each application's K/V into its slot and leaves the
  spare slot zero.  The reference's prefill also writes the K/V of the
  unflagged layers after the last application into the last slot, which no
  output ever reads (ROADMAP C14);
* ``decode_step`` writes the new SSM/conv states and K/V rows into the
  cache's tensors in place and returns them.

Each weight is cast to the compute dtype where it is used (no working
copy): ``dt_bias``, ``a_log``, ``d_skip`` and the norm scales are used in
float32.  The embedding is not scaled.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import TensorSpec, ZooModel, _ckpt, ce_loss
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlpm
from repro_torch.nn import ssm
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.params import PDef
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor


class ZambaHybrid(ZooModel):
    def __init__(self, cfg: ArchConfig, mesh=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, mesh, device=device, generator=generator)
        self.attn_cfg = attn.AttnCfg(
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            rope_theta=cfg.rope_theta, causal=True, q_chunk=cfg.q_chunk,
            remat_chunks=cfg.flash_remat)
        self.n_app = -(-cfg.n_layers // cfg.attn_every)
        self._flags = [(l + 1) % cfg.attn_every == 0 for l in range(cfg.n_layers)]

    @staticmethod
    def defs_of(cfg: ArchConfig) -> Dict[str, object]:
        L, d = cfg.n_layers, cfg.d_model
        blocks = dict(ssm.mamba2_defs(L, d, cfg.ssm_state))
        blocks["norm0"] = PDef((L, d), ("layers", None), init="zeros")
        shared = {}
        shared.update(attn.attn_defs(1, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd))
        shared.update(mlpm.glu_defs(1, d, cfg.d_ff, cfg.quant))
        shared["norm0"] = PDef((1, d), ("layers", None), init="zeros")
        shared["norm1"] = PDef((1, d), ("layers", None), init="zeros")
        return {
            "embed": PDef((cfg.vocab, d), ("vocab", "embed")),
            "blocks": blocks,
            "shared": shared,
            "final_norm": PDef((d,), (None,), init="zeros"),
            "head": PDef((d, cfg.vocab), ("embed", "vocab")),
        }

    def _shared(self) -> Dict[str, Tensor]:
        return self._layer(self._stack("shared"), 0)

    def _shared_block(self, sp: dict, x: Tensor, positions, cache_kv=None, index=None,
                      return_kv: bool = False):
        """The shared attention + GLU block.  Returns (x, kv, ebops): kv is
        the block's own (K, V) with ``return_kv``, the updated caches with
        ``cache_kv``, else None."""
        h = self._rows(rms_norm(x, sp["norm0"]))
        if cache_kv is None:
            out = attn.multihead_attention(sp, h, self.attn_cfg, positions=positions,
                                           return_kv=return_kv)
            a, kv = out if return_kv else (out, None)
        else:
            a, kc, vc = attn.decode_attention(sp, h, self.attn_cfg, *cache_kv, index)
            kv = (kc, vc)
        x = x + a
        h2 = self._rows(rms_norm(x, sp["norm1"]))
        m, eb = mlpm.glu_apply(sp, h2, self.cfg.act, self.cfg.quant)
        return x + m, kv, eb

    def _mamba(self, pl: dict, x: Tensor, state: Optional[dict] = None):
        m, st = ssm.mamba2_apply(pl, self._rows(rms_norm(x, pl["norm0"])), self.cfg.ssm_state,
                                 state)
        return x + m, st

    def _embed(self, tokens: Tensor) -> Tensor:
        return self._lookup(tokens)

    # ------------------------------------------------------------------ fwd
    def hidden_states(self, batch) -> Tuple[Tensor, Tensor, Tensor]:
        """Full-sequence forward -> (hidden (B,S,D), ebops, aux_loss = 0)."""
        x = self._embed(batch["tokens"])
        b, s = batch["tokens"].shape
        positions = self._positions(b, s)
        blocks, sp = self._stack("blocks"), self._shared()
        ebs = []
        for l, flag in enumerate(self._flags):
            pl = self._layer(blocks, l)

            def body(x_in, pl=pl, flag=flag):
                y, _ = self._mamba(pl, x_in)
                eb = None
                if flag:
                    y, _, eb = self._shared_block(sp, y, positions)
                return self._constrain(y, "batch", None, None), eb

            x, eb = _ckpt(body, x) if self.cfg.remat else body(x)
            if eb is not None:
                ebs.append(eb)
        x = rms_norm(x, self.get_parameter("final_norm"))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, (torch.sum(torch.stack(ebs)) if ebs else zero), zero

    def loss(self, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Chunked-CE training loss + metrics. batch: tokens, labels (B,S)."""
        x, ebops, aux = self.hidden_states(batch)
        ce = ce_loss(x, self.get_parameter("head").to(self.compute_dtype), batch["labels"],
                     self.cfg.ce_remat, self.mesh)
        return ce, {"ce": ce, "ebops": ebops, "aux_loss": aux}

    # -------------------------------------------------------------- serving
    def cache_defs(self, batch: int, t: int) -> Dict[str, PDef]:
        cfg = self.cfg
        di = 2 * cfg.d_model
        h = di // ssm.MAMBA_HEAD
        L = cfg.n_layers
        kv = ("layers", "batch", "kv_heads", "kv_seq", None)
        return {
            "ssm": PDef((L, batch, h, ssm.MAMBA_HEAD, cfg.ssm_state),
                        ("layers", "batch", "ffn", None, None), init="zeros",
                        dtype=torch.float32),
            "conv": PDef((L, batch, ssm.CONV_K - 1, di + 2 * cfg.ssm_state),
                         ("layers", "batch", None, None), init="zeros",
                         dtype=self.compute_dtype),
            "k": PDef((self.n_app, batch, cfg.n_kv_heads, t, cfg.hd), kv, init="zeros",
                      dtype=self.compute_dtype),
            "v": PDef((self.n_app, batch, cfg.n_kv_heads, t, cfg.hd), kv, init="zeros",
                      dtype=self.compute_dtype),
            "index": PDef((), (), init="zeros", dtype=torch.int32),
        }

    def prefill(self, batch, cache_len: Optional[int] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Full-context forward that also builds the cache: every layer's
        final SSM/conv states, and each application's K/V at
        ``cache_len`` positions (default the prompt's length S; zeros past
        S)."""
        b, s = batch["tokens"].shape
        t = s if cache_len is None else cache_len
        if t < s:
            raise ValueError(f"cache_len {t} is shorter than the prompt {s}")
        x = self._embed(batch["tokens"])
        positions = self._positions(b, s)
        blocks, sp = self._stack("blocks"), self._shared()
        cache = self._zero_cache(b, t)
        app = 0
        for l, flag in enumerate(self._flags):
            zero = {"ssm": torch.zeros_like(cache["ssm"][l]),
                    "conv": torch.zeros_like(cache["conv"][l])}
            x, st = self._mamba(self._layer(blocks, l), x, zero)
            shd.assign(cache["ssm"], (l,), st["ssm"])
            shd.assign(cache["conv"], (l,), st["conv"])
            if flag:
                x, (k, v), _ = self._shared_block(sp, x, positions, return_kv=True)
                rows = (app, slice(None), slice(None), slice(0, s))
                shd.assign(cache["k"], rows, k.transpose(1, 2))
                shd.assign(cache["v"], rows, v.transpose(1, 2))
                app += 1
        x = rms_norm(x, self.get_parameter("final_norm"))
        cache["index"] = self._index(s)
        return self._serve_logits(x[:, -1], self.get_parameter("head")), cache

    def decode_step(self, cache: Dict[str, Tensor], tokens: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One serve step: next-token logits + the cache. tokens (B,).  The
        states and K/V rows are written into the cache's tensors in place."""
        index = cache["index"]
        x = self._embed(tokens[:, None])
        blocks, sp = self._stack("blocks"), self._shared()
        app = 0
        for l, flag in enumerate(self._flags):
            x, st = self._mamba(self._layer(blocks, l), x,
                                {"ssm": cache["ssm"][l], "conv": cache["conv"][l]})
            shd.assign(cache["ssm"], (l,), st["ssm"])
            shd.assign(cache["conv"], (l,), st["conv"])
            if flag:
                x, _, _ = self._shared_block(sp, x, None, index=index,
                                             cache_kv=(cache["k"][app], cache["v"][app]))
                app += 1
        x = rms_norm(x, self.get_parameter("final_norm"))
        return (self._serve_logits(x[:, 0], self.get_parameter("head")),
                {**cache, "index": index + 1})

    def input_specs(self, seq_len: int, batch: int, mode: str) -> Dict[str, TensorSpec]:
        tok = TensorSpec((batch, seq_len), torch.int32)
        if mode == "train":
            return {"tokens": tok, "labels": tok}
        if mode == "prefill":
            return {"tokens": tok}
        return {"tokens": TensorSpec((batch,), torch.int32)}
