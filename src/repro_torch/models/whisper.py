"""Whisper-style encoder-decoder, the audio backbone with its conv frontend
stubbed (port of ``repro.models.whisper``).

As in the reference, the modality frontend is a stub: ``input_specs``
supplies precomputed frame embeddings ``frames`` (B, enc_ctx, D), bf16.
Encoder layers are bidirectional self-attention + MLP with sinusoidal
positions; decoder layers add causal self-attention with a KV cache and
cross-attention onto the encoder output, with the learned ``dec_pos``
positions and the head tied to ``embed.T``.  The parameters keep the
reference's paths and shapes (``enc_blocks/*``, ``dec_blocks/x_wq``...).

* Cross-attention projects its K/V from the encoder output once a layer
  (``kv=``) and only its queries from the decoder stream; the reference
  also projects the decoder stream's K/V there and discards them.
* The caches are the self-attention ``k``/``v`` at ``cache_len`` positions
  and the cross ``xk``/``xv`` at ``enc_ctx``, computed once at prefill;
  decode writes its self K/V rows in place.
* The encoder's MLP EBOPs are discarded, as in the reference (its
  quantizers still run: kernel B1 on the card); only the decoder's reach
  the loss.
* Each weight is cast to the compute dtype where it is used; the norm
  scales and biases are used in float32.  The decoder positions stop at
  ``MAX_DEC_POS``: ``prefill`` refuses a cache (``cache_len``, default
  the prompt) longer than that, a host check with no sync, and
  ``launch/serve.py`` a longer prompt + generation; a decode past the
  cache raises (ROADMAP C16: the reference's ``jnp.take`` fills NaN past
  the positions and its cache write clamps onto the last row, where a
  CUDA gather would assert).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import TensorSpec, ZooModel, _ckpt, ce_loss
from repro_torch.nn import attention as attn
from repro_torch.nn import mlp as mlpm
from repro_torch.nn.layers import layer_norm, sinusoidal_positions
from repro_torch.nn.params import PDef
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor

MAX_DEC_POS = 32768 + 8  # covers the decode_32k cell


class WhisperEncDec(ZooModel):
    max_positions = MAX_DEC_POS

    def __init__(self, cfg: ArchConfig, mesh=None, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, mesh, device=device, generator=generator)
        base = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
                    use_rope=False, q_chunk=cfg.q_chunk, remat_chunks=cfg.flash_remat)
        self.enc_attn = attn.AttnCfg(causal=False, **base)
        self.dec_attn = attn.AttnCfg(causal=True, **base)

    @staticmethod
    def defs_of(cfg: ArchConfig) -> Dict[str, object]:
        d = cfg.d_model

        def block_defs(n_layers, cross: bool):
            b = {}
            b.update(attn.attn_defs(n_layers, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd))
            if cross:
                cr = attn.attn_defs(n_layers, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
                b.update({f"x_{k}": v for k, v in cr.items()})
            b.update(mlpm.mlp_defs(n_layers, d, cfg.d_ff, cfg.quant))
            for k in range(3 if cross else 2):
                b[f"norm{k}"] = PDef((n_layers, d), ("layers", None), init="zeros")
                b[f"norm{k}_b"] = PDef((n_layers, d), ("layers", None), init="zeros")
            return b

        return {
            "embed": PDef((cfg.vocab, d), ("vocab", "embed")),
            "dec_pos": PDef((MAX_DEC_POS, d), (None, "embed"), scale=0.02),
            "enc_blocks": block_defs(cfg.n_enc_layers, cross=False),
            "dec_blocks": block_defs(cfg.n_layers, cross=True),
            "enc_norm": PDef((d,), (None,), init="zeros"),
            "enc_norm_b": PDef((d,), (None,), init="zeros"),
            "dec_norm": PDef((d,), (None,), init="zeros"),
            "dec_norm_b": PDef((d,), (None,), init="zeros"),
        }

    @staticmethod
    def _ln(pl: dict, idx: int, x: Tensor) -> Tensor:
        return layer_norm(x, 1.0 + pl[f"norm{idx}"], pl[f"norm{idx}_b"])

    def _final_ln(self, x: Tensor, name: str) -> Tensor:
        return layer_norm(x, 1.0 + self.get_parameter(name), self.get_parameter(name + "_b"))

    # ---------------------------------------------------------------- encode
    def encode(self, frames: Tensor) -> Tensor:
        """frames (B, enc_ctx, D) precomputed (stub frontend) -> encoder output."""
        x = frames.to(self.compute_dtype)
        x = x + sinusoidal_positions(x.shape[1], x.shape[2], x.device).to(x.dtype)[None]
        blocks = self._stack("enc_blocks")
        for l in range(self.cfg.n_enc_layers):
            pl = self._layer(blocks, l)

            def body(x_in, pl=pl):
                x_in = x_in + attn.multihead_attention(pl, self._rows(self._ln(pl, 0, x_in)),
                                                       self.enc_attn)
                m, _ = mlpm.mlp_apply(pl, self._rows(self._ln(pl, 1, x_in)), self.cfg.act,
                                      self.cfg.quant)
                return self._constrain(x_in + m, "batch", None, None)

            x = _ckpt(body, x) if self.cfg.remat else body(x)
        return self._final_ln(x, "enc_norm")

    # ---------------------------------------------------------------- decode
    @staticmethod
    def _cross_kv(pl: dict, enc_out: Tensor) -> Tuple[Tensor, Tensor]:
        return attn._proj(enc_out, pl["x_wk"]), attn._proj(enc_out, pl["x_wv"])

    def _dec_block(self, pl: dict, x: Tensor, cross_kv, positions, cache=None, index=None,
                   return_kv: bool = False):
        """One decoder layer.  Full sequence: ``cross_kv`` is the layer's
        cross K/V, each (B,T,K,hd); decode: ``cache`` holds the layer's
        ``k``/``v``/``xk``/``xv`` and the self K/V row is written in place.
        Returns (x, the self (K, V) with ``return_kv`` else None, ebops)."""
        h = self._rows(self._ln(pl, 0, x))
        self_kv = None
        if cache is None:
            out = attn.multihead_attention(pl, h, self.dec_attn, positions=positions,
                                           return_kv=return_kv)
            a, self_kv = out if return_kv else (out, None)
        else:
            a, _, _ = attn.decode_attention(pl, h, self.dec_attn, cache["k"], cache["v"], index)
        x = x + a
        h2 = self._rows(self._ln(pl, 1, x))
        if cache is None:
            c = attn.multihead_attention(pl, h2, self.dec_attn, kv=cross_kv, prefix="x_")
        else:
            xq = attn.project_q(pl, h2, self.dec_attn, None, prefix="x_")
            out = attn.attention_core(xq, cache["xk"].transpose(1, 2),
                                      cache["xv"].transpose(1, 2), self.dec_attn, causal=False)
            c = attn._out_proj(out, pl["x_wo"], x.dtype)
        x = x + c
        m, eb = mlpm.mlp_apply(pl, self._rows(self._ln(pl, 2, x)), self.cfg.act, self.cfg.quant)
        return self._constrain(x + m, "batch", None, None), self_kv, eb

    def _dec_inputs(self, tokens: Tensor) -> Tensor:
        s = tokens.shape[1]
        if s > MAX_DEC_POS:
            raise ValueError(f"{s} decoder tokens: Whisper's positions stop at {MAX_DEC_POS}")
        x = self._lookup(tokens)
        return x + self.get_parameter("dec_pos")[:s].to(x.dtype)[None]

    def hidden_states(self, batch) -> Tuple[Tensor, Tensor, Tensor]:
        """Encoder, then the decoder over ``tokens`` -> (hidden (B,S,D),
        the decoder's EBOPs, aux_loss = 0)."""
        enc_out = self.encode(batch["frames"])
        b, s = batch["tokens"].shape
        x = self._dec_inputs(batch["tokens"])
        positions = self._positions(b, s)
        blocks = self._stack("dec_blocks")
        ebs = []
        for l in range(self.cfg.n_layers):
            pl = self._layer(blocks, l)

            def body(x_in, enc, pl=pl):
                y, _, eb = self._dec_block(pl, x_in, self._cross_kv(pl, enc), positions)
                return y, eb

            x, eb = _ckpt(body, x, enc_out) if self.cfg.remat else body(x, enc_out)
            ebs.append(eb)
        x = self._final_ln(x, "dec_norm")
        return x, torch.sum(torch.stack(ebs)), torch.zeros((), dtype=torch.float32,
                                                           device=x.device)

    def _head(self) -> Tensor:
        return self.get_parameter("embed").T

    def loss(self, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Chunked-CE training loss + metrics. batch: frames, tokens, labels."""
        x, ebops, aux = self.hidden_states(batch)
        ce = ce_loss(x, self._head().to(self.compute_dtype), batch["labels"], self.cfg.ce_remat,
                     self.mesh)
        return ce, {"ce": ce, "ebops": ebops, "aux_loss": aux}

    # -------------------------------------------------------------- serving
    def cache_defs(self, batch: int, t: int) -> Dict[str, PDef]:
        cfg = self.cfg
        L = cfg.n_layers
        kv = ("layers", "batch", "kv_heads", "kv_seq", None)
        self_kv = PDef((L, batch, cfg.n_kv_heads, t, cfg.hd), kv, init="zeros",
                       dtype=self.compute_dtype)
        cross = PDef((L, batch, cfg.n_kv_heads, cfg.enc_ctx, cfg.hd), kv, init="zeros",
                     dtype=self.compute_dtype)
        return {"k": self_kv, "v": self_kv, "xk": cross, "xv": cross,
                "index": PDef((), (), init="zeros", dtype=torch.int32)}

    def prefill(self, batch, cache_len: Optional[int] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Encoder and decoder forward that also builds the caches: self K/V
        at ``cache_len`` positions (default the prompt's length S; zeros
        past S) and the cross K/V of the encoder output."""
        b, s = batch["tokens"].shape
        t = s if cache_len is None else cache_len
        if t < s:
            raise ValueError(f"cache_len {t} is shorter than the prompt {s}")
        if t > self.max_positions:
            raise ValueError(f"cache_len {t} is past the decoder's {self.max_positions} "
                             f"positions")
        enc_out = self.encode(batch["frames"])
        x = self._dec_inputs(batch["tokens"])
        positions = self._positions(b, s)
        blocks = self._stack("dec_blocks")
        cache = self._zero_cache(b, t)
        for l in range(self.cfg.n_layers):
            pl = self._layer(blocks, l)
            xk, xv = self._cross_kv(pl, enc_out)
            x, (k, v), _ = self._dec_block(pl, x, (xk, xv), positions, return_kv=True)
            rows = (l, slice(None), slice(None), slice(0, s))
            shd.assign(cache["k"], rows, k.transpose(1, 2))
            shd.assign(cache["v"], rows, v.transpose(1, 2))
            shd.assign(cache["xk"], (l,), xk.transpose(1, 2))
            shd.assign(cache["xv"], (l,), xv.transpose(1, 2))
        x = self._final_ln(x, "dec_norm")
        cache["index"] = self._index(s)
        return self._serve_logits(x[:, -1], self._head()), cache

    def decode_step(self, cache: Dict[str, Tensor], tokens: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One serve step: next-token logits + the cache (self K/V rows
        written in place). tokens (B,)."""
        index = cache["index"]
        x = self._lookup(tokens[:, None])
        pos = shd.gather_rows(self.get_parameter("dec_pos"), index.reshape(1).long())
        x = x + pos.to(x.dtype)[None]
        blocks = self._stack("dec_blocks")
        for l in range(self.cfg.n_layers):
            x, _, _ = self._dec_block(self._layer(blocks, l), x, None, None, index=index,
                                      cache={k: cache[k][l] for k in ("k", "v", "xk", "xv")})
        x = self._final_ln(x, "dec_norm")
        return self._serve_logits(x[:, 0], self._head()), {**cache, "index": index + 1}

    def input_specs(self, seq_len: int, batch: int, mode: str) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        frames = TensorSpec((batch, cfg.enc_ctx, cfg.d_model), torch.bfloat16)
        tok = TensorSpec((batch, seq_len), torch.int32)
        if mode == "train":
            return {"frames": frames, "tokens": tok, "labels": tok}
        if mode == "prefill":
            return {"frames": frames, "tokens": tok}
        return {"tokens": TensorSpec((batch,), torch.int32)}
