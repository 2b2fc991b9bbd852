"""RWKV-6 "Finch" LM: attention-free, O(1)-state decode (port of
``repro.models.rwkv``).

The stacked ``blocks/*`` parameters keep the reference's paths and shapes;
each layer is a time mix (the WKV recurrence, ``nn/ssm.py``: chunked for a
sequence, the scan for a decode step) and a channel mix, each behind a
LayerNorm whose scale is ``1 + norm``.  The embedding is followed by
``ln_in`` and not scaled.  Decode threads the (wkv, token-shift) states,
written into the cache's tensors in place, so a step after a 32k prompt
costs what one after 512 tokens does; ``cache_len`` is accepted and
ignored, as there is no length-bound state.

The config sets ``quant="hgq"``, but the model calls no quantizer (nor does
the reference's): its EBOPs are 0 and it launches no kernel B1.  Each
weight is cast to the compute dtype where it is used; ``w0``, the decay
LoRA, ``u_bonus`` and the norm scales and biases are used in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import TensorSpec, ZooModel, _ckpt, ce_loss
from repro_torch.nn import ssm
from repro_torch.nn.layers import layer_norm
from repro_torch.nn.params import PDef
from repro_torch.parallel import sharding as shd

Tensor = torch.Tensor
STATE_KEYS = ("wkv", "shift_t", "shift_c")


class RWKV6LM(ZooModel):
    @staticmethod
    def defs_of(cfg: ArchConfig) -> Dict[str, object]:
        L, d = cfg.n_layers, cfg.d_model
        blocks = dict(ssm.rwkv6_defs(L, d, cfg.d_ff))
        for nm in ("norm0", "norm0_b", "norm1", "norm1_b"):
            blocks[nm] = PDef((L, d), ("layers", None), init="zeros")
        return {
            "embed": PDef((cfg.vocab, d), ("vocab", "embed")),
            "ln_in": PDef((d,), (None,), init="zeros"),
            "ln_in_b": PDef((d,), (None,), init="zeros"),
            "blocks": blocks,
            "final_norm": PDef((d,), (None,), init="zeros"),
            "final_norm_b": PDef((d,), (None,), init="zeros"),
            "head": PDef((d, cfg.vocab), ("embed", "vocab")),
        }

    def _ln(self, x: Tensor, name: str, pl: Optional[dict] = None) -> Tensor:
        """LayerNorm with scale ``1 + name`` and bias ``name_b``, from the
        layer's parameters ``pl`` or the model's own."""
        get = pl.__getitem__ if pl is not None else self.get_parameter
        return layer_norm(x, 1.0 + get(name), get(name + "_b"))

    def _block(self, pl: dict, x: Tensor, state: Optional[dict]):
        """One layer -> (x, its new wkv / shift_t / shift_c states)."""
        a, st_t = ssm.rwkv6_time_mix(pl, self._rows(self._ln(x, "norm0", pl)), state)
        x = x + a
        c, st_c = ssm.rwkv6_channel_mix(pl, self._rows(self._ln(x, "norm1", pl)), state)
        return self._constrain(x + c, "batch", None, None), {**st_t, **st_c}

    def _embed(self, tokens: Tensor) -> Tensor:
        x = self._lookup(tokens)
        return self._ln(x, "ln_in")

    # ------------------------------------------------------------------ fwd
    def hidden_states(self, batch) -> Tuple[Tensor, Tensor, Tensor]:
        """Full-sequence forward -> (hidden (B,S,D), ebops = 0, aux_loss = 0)."""
        x = self._embed(batch["tokens"])
        blocks = self._stack("blocks")
        for l in range(self.cfg.n_layers):
            pl = self._layer(blocks, l)

            def body(x_in, pl=pl):
                return self._block(pl, x_in, None)[0]

            x = _ckpt(body, x) if self.cfg.remat else body(x)
        x = self._ln(x, "final_norm")
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, zero, zero.clone()

    def loss(self, batch) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Chunked-CE training loss + metrics. batch: tokens, labels (B,S)."""
        x, ebops, aux = self.hidden_states(batch)
        ce = ce_loss(x, self.get_parameter("head").to(self.compute_dtype), batch["labels"],
                     self.cfg.ce_remat, self.mesh)
        return ce, {"ce": ce, "ebops": ebops, "aux_loss": aux}

    # -------------------------------------------------------------- serving
    def cache_defs(self, batch: int, t: int) -> Dict[str, PDef]:
        L, d = self.cfg.n_layers, self.cfg.d_model
        h = d // ssm.RWKV_HEAD
        shift = PDef((L, batch, 1, d), ("layers", "batch", None, None), init="zeros",
                     dtype=self.compute_dtype)
        return {
            "wkv": PDef((L, batch, h, ssm.RWKV_HEAD, ssm.RWKV_HEAD),
                        ("layers", "batch", "heads", None, None), init="zeros",
                        dtype=torch.float32),
            "shift_t": shift,
            "shift_c": shift,
            "index": PDef((), (), init="zeros", dtype=torch.int32),
        }

    def _run_cached(self, x: Tensor, cache: Dict[str, Tensor], zero: bool) -> Tensor:
        """Every layer from the cache's states (zeros with ``zero``), each new
        state written into the cache in place."""
        blocks = self._stack("blocks")
        for l in range(self.cfg.n_layers):
            state = {k: torch.zeros_like(cache[k][l]) if zero else cache[k][l]
                     for k in STATE_KEYS}
            x, st = self._block(self._layer(blocks, l), x, state)
            for k in STATE_KEYS:
                shd.assign(cache[k], (l,), st[k])
        return self._ln(x, "final_norm")

    def prefill(self, batch, cache_len: Optional[int] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Full-context forward that also returns every layer's final
        states (``cache_len`` is ignored: the state has no length)."""
        b, s = batch["tokens"].shape
        cache = self._zero_cache(b, 0)
        x = self._run_cached(self._embed(batch["tokens"]), cache, zero=True)
        cache["index"] = self._index(s)
        return self._serve_logits(x[:, -1], self.get_parameter("head")), cache

    def decode_step(self, cache: Dict[str, Tensor], tokens: Tensor
                    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """One serve step: next-token logits + the cache (states updated in
        place). tokens (B,)."""
        x = self._run_cached(self._embed(tokens[:, None]), cache, zero=False)
        return (self._serve_logits(x[:, 0], self.get_parameter("head")),
                {**cache, "index": cache["index"] + 1})

    def input_specs(self, seq_len: int, batch: int, mode: str) -> Dict[str, TensorSpec]:
        tok = TensorSpec((batch, seq_len), torch.int32)
        if mode == "train":
            return {"tokens": tok, "labels": tok}
        if mode == "prefill":
            return {"tokens": tok}
        return {"tokens": TensorSpec((batch,), torch.int32)}
