"""Grouped-query attention with q-chunked scoring (port of ``repro.nn.attention``).

Covers the zoo's attention variants: GQA with any (n_heads, n_kv_heads)
grouping, qk-norm (qwen3), QKV bias (qwen1.5), sliding windows and
local:global layer mixes (gemma3; the window is a per-layer scalar),
bidirectional encoder attention and cross-attention (whisper; ``prefix``
selects a second set of weights, ``x_wq``...), and decode steps against
pre-allocated (B, K, T, hd) KV caches.

Scores are computed per query chunk of ``q_chunk`` rows, so the full (S, S)
score matrix never materialises; with ``remat_chunks`` each chunk runs
under ``torch.utils.checkpoint`` and its probabilities are recomputed in the
backward, as the reference's ``jax.checkpoint`` per chunk.  The math is the
reference's: float32 scores (the bf16 products are exact in float32, so
q and k are widened before the product), the ``NEG_INF`` mask, the window
test ``q - k < win`` with ``NO_WINDOW`` for global layers, float32 softmax,
and the probabilities cast to v's dtype before the second product.  It is
plain PyTorch, as the reference's is plain ``jnp`` outside any Pallas
kernel; ``F.scaled_dot_product_attention`` would round differently.

A decode step writes its K/V row into the cache in place
(``index_copy_``), where the reference donates the cache to
``dynamic_update_slice``: a functional copy of a 32k-token cache would move
gigabytes a step.

Cross-attention (``kv=`` given) projects only the queries from ``x``: the
reference also projects K/V from the decoder stream and discards them,
which XLA removes and eager PyTorch would not.  With ``return_kv`` the self
K/V are projected all the same, as the reference returns them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.layers import rms_norm, rope
from repro_torch.nn.params import PDef

NEG_INF = -1e30
NO_WINDOW = (1 << 31) - 1  # "global" sentinel for int32 window scalars

Window = Union[int, torch.Tensor, None]


# --------------------------------------------------------------------- defs
def attn_defs(n_layers: int, d: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False, qkv_bias: bool = False) -> dict:
    L = n_layers
    defs = {
        "wq": PDef((L, d, n_heads, head_dim), ("layers", "embed", "heads", None)),
        "wk": PDef((L, d, n_kv, head_dim), ("layers", "embed", "kv_heads", None)),
        "wv": PDef((L, d, n_kv, head_dim), ("layers", "embed", "kv_heads", None)),
        "wo": PDef((L, n_heads, head_dim, d), ("layers", "heads", None, "embed")),
    }
    if qkv_bias:
        defs["bq"] = PDef((L, n_heads, head_dim), ("layers", "heads", None), init="zeros")
        defs["bk"] = PDef((L, n_kv, head_dim), ("layers", "kv_heads", None), init="zeros")
        defs["bv"] = PDef((L, n_kv, head_dim), ("layers", "kv_heads", None), init="zeros")
    if qk_norm:
        defs["q_scale"] = PDef((L, head_dim), ("layers", None), init="zeros")
        defs["k_scale"] = PDef((L, head_dim), ("layers", None), init="zeros")
    return defs


def cache_defs(n_layers: int, batch: int, t: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16) -> dict:
    """Stacked KV cache PDefs, (L, B, K, T, hd)."""
    sh = (n_layers, batch, n_kv, t, head_dim)
    ax = ("layers", "batch", "kv_heads", "kv_seq", None)
    return {"k": PDef(sh, ax, init="zeros", dtype=dtype),
            "v": PDef(sh, ax, init="zeros", dtype=dtype)}


class AttnCfg(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True
    q_chunk: int = 128
    # recompute each q-chunk's scores and probabilities in the backward
    remat_chunks: bool = True


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dnh->bsnh")`` as one matmul."""
    d, n, h = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, n * h)).unflatten(-1, (n, h))


def project_q(p, x, cfg: AttnCfg, positions: Optional[torch.Tensor], prefix: str = ""):
    """The queries of :func:`project_qkv` alone."""
    q = _proj(x, p[prefix + "wq"])
    if cfg.qkv_bias:
        q = q + p[prefix + "bq"].to(x.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, p[prefix + "q_scale"])
    if cfg.use_rope and positions is not None:
        q = rope(q, positions, cfg.rope_theta)
    return q


def project_kv(p, x, cfg: AttnCfg, positions: Optional[torch.Tensor], prefix: str = ""):
    """The keys and values of :func:`project_qkv` alone."""
    k = _proj(x, p[prefix + "wk"])
    v = _proj(x, p[prefix + "wv"])
    if cfg.qkv_bias:
        k = k + p[prefix + "bk"].to(x.dtype)
        v = v + p[prefix + "bv"].to(x.dtype)
    if cfg.qk_norm:
        k = rms_norm(k, p[prefix + "k_scale"])
    if cfg.use_rope and positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    return k, v


def project_qkv(p, x, cfg: AttnCfg, positions: Optional[torch.Tensor], prefix: str = ""):
    return (project_q(p, x, cfg, positions, prefix),
            *project_kv(p, x, cfg, positions, prefix))


def _chunk(qc, qp, kt, v, k_pos, causal: bool, win, scale: float):
    """One q-chunk in the heads-major layout: queries (B, K, qc, G, hd) at
    positions (B, qc) against float32 keys kt (B, K, hd, T) and values
    (B, K, T, hd) -> (B, K, qc, G, hd) in v's dtype."""
    b, kvh, n, g, hd = qc.shape
    t = kt.shape[-1]
    sc = torch.matmul(qc.reshape(b, kvh, n * g, hd).float(), kt) * scale
    mask = qp[:, :, None] - k_pos[None, None, :] < win
    if causal:
        mask = mask & (k_pos[None, None, :] <= qp[:, :, None])
    sc = torch.where(mask[:, None, :, None, :], sc.view(b, kvh, n, g, t), NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.matmul(pr.to(v.dtype).view(b, kvh, n * g, t), v)
    return out.view(b, kvh, n, g, hd)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: AttnCfg, *,
                   q_positions: Optional[torch.Tensor] = None,
                   window: Window = None, causal: Optional[bool] = None) -> torch.Tensor:
    """q (B,S,N,hd) × k,v (B,T,K,hd) -> (B,S,N,hd), q-chunked.

    ``window`` may be a per-layer scalar (NO_WINDOW = global attention);
    ``causal`` overrides ``cfg.causal``.
    The chunks run heads-major, (B, K, ·, G, hd), so that K and V are laid
    out once a call (keys as float32 and transposed) and every chunk is two
    batched matmuls over them.
    """
    b, s, n, hd = q.shape
    t = k.shape[1]
    kvh = cfg.n_kv
    g = n // kvh
    win = NO_WINDOW if window is None else window
    causal = cfg.causal if causal is None else causal

    qc = min(cfg.q_chunk, s)
    pad = -s % qc
    q_pos = (q_positions if q_positions is not None
             else torch.arange(s, device=q.device).expand(b, s))
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=0)
    nc = (s + pad) // qc
    qh = q.reshape(b, s + pad, kvh, g, hd).permute(0, 2, 1, 3, 4)       # (B,K,S,G,hd)
    kt = k.float().permute(0, 2, 3, 1).contiguous()                     # (B,K,hd,T)
    vh = v.permute(0, 2, 1, 3).contiguous()                             # (B,K,T,hd)
    k_pos = torch.arange(t, device=q.device)
    remat = cfg.remat_chunks and torch.is_grad_enabled()
    outs = []
    for c in range(nc):
        args = (qh[:, :, c * qc:(c + 1) * qc], q_pos[:, c * qc:(c + 1) * qc], kt, vh,
                k_pos, causal, win, hd ** -0.5)
        if remat:
            outs.append(checkpoint(_chunk, *args, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(_chunk(*args))
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3, 4).reshape(b, s + pad, n, hd)
    return out[:, :s]


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")`` as one matmul."""
    n, h, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.to(dtype).reshape(n * h, d))


def multihead_attention(p: dict, x: torch.Tensor, cfg: AttnCfg, *,
                        positions: Optional[torch.Tensor] = None,
                        window: Window = None,
                        kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        prefix: str = "", return_kv: bool = False):
    """Full-sequence attention (training / prefill). x: (B,S,D) -> (B,S,D).

    ``kv`` (each (B,T,K,hd)) makes it cross-attention onto that source,
    non-causal; ``prefix`` picks the weights (``x_wq``...).  With
    ``return_kv`` also the self (K, V) of ``x``, each (B,S,K,hd)."""
    q = project_q(p, x, cfg, positions, prefix)
    self_kv = project_kv(p, x, cfg, positions, prefix) if kv is None or return_kv else None
    k, v = self_kv if kv is None else kv
    out = attention_core(q, k, v, cfg, q_positions=positions, window=window,
                         causal=cfg.causal if kv is None else False)
    y = _out_proj(out, p[prefix + "wo"], x.dtype)
    if return_kv:
        return y, self_kv
    return y


def decode_attention(p: dict, x: torch.Tensor, cfg: AttnCfg, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor, *,
                     window: Window = None, prefix: str = "", update_cache: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a full-length (B, K, T, hd) KV cache.

    ``index`` is the step's position, a 0-d integer tensor on the cache's
    device (no host sync).  The new K/V row is written into
    ``k_cache``/``v_cache`` in place (unless ``update_cache`` is False),
    and they are returned.
    Window layers mask old positions; the cache stays full-length.
    """
    b = x.shape[0]
    n, kvh, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    g = n // kvh
    win = NO_WINDOW if window is None else window
    pos = index.reshape(1, 1).expand(b, 1)
    q = project_q(p, x, cfg, pos, prefix)                          # (B,1,N,hd)

    t = k_cache.shape[2]
    if update_cache:
        k_new, v_new = project_kv(p, x, cfg, pos, prefix)
        at = index.reshape(1).long()
        k_cache.index_copy_(2, at, k_new.transpose(1, 2).to(k_cache.dtype))
        v_cache.index_copy_(2, at, v_new.transpose(1, 2).to(v_cache.dtype))

    qh = q.reshape(b, kvh, g, hd)
    sc = torch.matmul(qh.float(), k_cache.float().transpose(-1, -2)) * hd ** -0.5
    tpos = torch.arange(t, device=x.device)
    mask = (tpos <= index) & (index - tpos < win)
    sc = torch.where(mask[None, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    out = torch.matmul(pr.to(x.dtype), v_cache.to(x.dtype))
    y = _out_proj(out.reshape(b, n, hd), p[prefix + "wo"], x.dtype)
    return y[:, None, :], k_cache, v_cache
