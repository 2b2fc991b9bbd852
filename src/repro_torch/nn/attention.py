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
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import grad_split_ready, split_ready, write_row

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
    """``einsum("bsd,dnh->bsnh")`` as one matmul (on a mesh, the product's
    (n·h) dim, and the weight's gradient there, gathered first where its
    shards do not divide n: C18)."""
    d, n, h = w.shape
    y = torch.matmul(x, grad_split_ready(w.to(x.dtype).reshape(d, n * h), -1, n))
    return split_ready(y, -1, n).unflatten(-1, (n, h))


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


def _sp_plan(qh, kt, vh):
    """``(t_dims, offset)`` when the chunks can run SP attention on each
    rank's shards (:func:`_chunk_sp`), else None (the DTensor ops run).

    Allowed: the heads-major queries (B, K, S, G, hd) sharded at most along
    the batch, the keys (B, K, hd, T) and values (B, K, T, hd) alike along
    the batch and along T over the same mesh dims ``t_dims`` (the ``model``
    axis of SP attention), nothing pending.  ``offset`` is the first key
    position of this rank's T shard."""
    from torch.distributed.tensor import DTensor

    if not all(isinstance(t, DTensor) for t in (qh, kt, vh)):
        return None
    t_dims = []
    for i, (pq, pk, pv) in enumerate(zip(qh.placements, kt.placements, vh.placements)):
        if any(p.is_partial() for p in (pq, pk, pv)):
            return None
        if pq.is_shard(0) != pk.is_shard(0) or pk.is_shard(0) != pv.is_shard(0):
            return None
        if pq.is_shard() and not pq.is_shard(0):
            return None
        if pk.is_shard(3) != pv.is_shard(2):
            return None
        if pk.is_shard(3):
            t_dims.append(i)
        elif (pk.is_shard() and not pk.is_shard(0)) or (pv.is_shard() and not pv.is_shard(0)):
            return None
    if not t_dims:
        return None
    mesh, coord = kt.device_mesh, kt.device_mesh.get_coordinate()
    offset = 0
    for i in t_dims:   # outer mesh dims first, as write_row
        offset = offset * mesh.size(i) + coord[i]
    return t_dims, offset * kt.to_local().shape[-1]


def _chunk_sp(qc, qp, kt, v, t0: int, t_dims, causal: bool, win, scale: float):
    """:func:`_chunk` on each rank's shards when K/V are sharded along T
    (SP attention): the rank's scores over its keys, the softmax's max and
    sum over every rank's keys (an all-reduce each over ``t_dims``), and its
    share of the output, a pending sum over ``t_dims``.  Without this
    DTensor shards the chunk products' merged (B·K) dim over the T axis as
    well, which the view back to (B, K) cannot split on the 3-D mesh
    (ROADMAP C18).  The max only steadies the exponent and carries no
    gradient."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = qc.device_mesh
    grad_q = [Partial() if i in t_dims else p for i, p in enumerate(qc.placements)]
    ql = qc.to_local(grad_placements=grad_q)
    ktl, vl = kt.to_local(), v.to_local()
    qpl = shd.local_rows(qp, qc)
    b, kvh, n, g, hd = ql.shape
    t = ktl.shape[-1]
    k_pos = torch.arange(t0, t0 + t, device=ql.device)
    sc = torch.matmul(ql.reshape(b, kvh, n * g, hd).float(), ktl) * scale
    mask = qpl[:, :, None] - k_pos[None, None, :] < win
    if causal:
        mask = mask & (k_pos[None, None, :] <= qpl[:, :, None])
    sc = torch.where(mask[:, None, :, None, :], sc.view(b, kvh, n, g, t), NEG_INF)
    top = sc.detach().amax(dim=-1, keepdim=True)
    for i in t_dims:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    e = torch.exp(sc - top)
    part = [Partial() if i in t_dims else p for i, p in enumerate(qc.placements)]
    whole = [Replicate() if i in t_dims else p for i, p in enumerate(qc.placements)]
    den = DTensor.from_local(e.sum(dim=-1, keepdim=True), mesh, part, run_check=False)
    # each rank's gradient of the sum covers its own keys: pending, and
    # summed over the T shards on its way back through the all-reduce
    pr = e / den.redistribute(mesh, whole).to_local(grad_placements=part)
    out = torch.matmul(pr.to(vl.dtype).view(b, kvh, n * g, t), vl)
    return DTensor.from_local(out.view(b, kvh, n, g, hd), mesh, part, run_check=False)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: AttnCfg, *,
                   q_positions: Optional[torch.Tensor] = None,
                   window: Window = None, causal: Optional[bool] = None) -> torch.Tensor:
    """q (B,S,N,hd) × k,v (B,T,K,hd) -> (B,S,N,hd), q-chunked.

    ``window`` may be a per-layer scalar (NO_WINDOW = global attention);
    ``causal`` overrides ``cfg.causal``.
    The chunks run heads-major, (B, K, ·, G, hd), so that K and V are laid
    out once a call (keys as float32 and transposed) and every chunk is two
    batched matmuls over them.  On a mesh whose shards hold whole (batch,
    GQA group) blocks the call runs on each rank's shards
    (``sharding.local_heads``).
    """
    local = shd.local_heads(q, k, v, cfg.n_kv)
    if local is not None:
        like, (ql, kl, vl), n_kv = local
        pos = None if q_positions is None else shd.local_rows(q_positions, like)
        out = attention_core(ql, kl, vl, cfg._replace(n_kv=n_kv, n_heads=ql.shape[2]),
                             q_positions=pos, window=window, causal=causal)
        return shd.from_local_like(out, like)
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
    qh = split_ready(q, 2, kvh).reshape(b, s + pad, kvh, g, hd).permute(0, 2, 1, 3, 4)       # (B,K,S,G,hd)
    kt = k.float().permute(0, 2, 3, 1).contiguous()                     # (B,K,hd,T)
    vh = v.permute(0, 2, 1, 3).contiguous()                             # (B,K,T,hd)
    k_pos = torch.arange(t, device=q.device)
    remat = cfg.remat_chunks and torch.is_grad_enabled()
    sp = _sp_plan(qh, kt, vh)
    outs = []
    for c in range(nc):
        fn, args = _chunk, (qh[:, :, c * qc:(c + 1) * qc], q_pos[:, c * qc:(c + 1) * qc],
                            kt, vh, k_pos, causal, win, hd ** -0.5)
        if sp is not None:
            fn, args = _chunk_sp, (*args[:4], sp[1], sp[0], *args[5:])
        if remat:
            outs.append(checkpoint(fn, *args, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(fn(*args))
    out = torch.cat(outs, dim=2)
    if sp is not None:
        # SP's pending sum over the T shards, reduced here: left pending,
        # DTensor reduce-scatters it along the sequence, which the output
        # projection's folded (B·S) rows cannot split back (C18)
        out = shd.replicate_partial(out)
    out = out.permute(0, 2, 1, 3, 4).reshape(b, s + pad, n, hd)
    return grad_split_ready(out, 2, kvh)[:, :s]


def _out_proj(out: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """``einsum("bsnh,nhd->bsd")`` as one matmul (on a mesh, the gradients
    of the merged (n·h) dims made ready for their split back: C18)."""
    n, h, d = wo.shape
    return torch.matmul(grad_split_ready(out.flatten(-2), -1, n),
                        grad_split_ready(wo.to(dtype).reshape(n * h, d), 0, n))


def multihead_attention(p: dict, x: torch.Tensor, cfg: AttnCfg, *,
                        positions: Optional[torch.Tensor] = None,
                        window: Window = None,
                        kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        prefix: str = "", return_kv: bool = False,
                        kv_constrain=None):
    """Full-sequence attention (training / prefill). x: (B,S,D) -> (B,S,D).

    ``kv`` (each (B,T,K,hd)) makes it cross-attention onto that source,
    non-causal; ``prefix`` picks the weights (``x_wq``...).  With
    ``return_kv`` also the self (K, V) of ``x``, each (B,S,K,hd).
    ``kv_constrain(tensor, *logical_axes)``, when given, shards K/V along
    the *sequence* axis over the ``model`` mesh axis (SP attention): the
    head count does not divide the mesh (qwen3: 40, arctic: 56 on a 16-way
    axis), so the score chain shards by T instead of being replicated."""
    q = project_q(p, x, cfg, positions, prefix)
    self_kv = project_kv(p, x, cfg, positions, prefix) if kv is None or return_kv else None
    k, v = self_kv if kv is None else kv
    if kv_constrain is not None:
        k = kv_constrain(k, "batch", "model", None, None)
        v = kv_constrain(v, "batch", "model", None, None)
        q = shd.grad_like(q)
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

    if update_cache:
        k_new, v_new = project_kv(p, x, cfg, pos, prefix)
        write_row(k_cache, 2, index, k_new.transpose(1, 2).to(k_cache.dtype))
        write_row(v_cache, 2, index, v_new.transpose(1, 2).to(v_cache.dtype))

    local = shd.local_heads(q, k_cache.transpose(1, 2), v_cache.transpose(1, 2), kvh)
    if local is None:
        qh = split_ready(q, 2, kvh).reshape(b, kvh, g, hd)
        out = _decode_scores(qh, k_cache, v_cache, index, win, x.dtype).reshape(b, n, hd)
    else:   # each rank's (batch, GQA group) shards, as attention_core
        like, (ql, kl, vl), kv_local = local
        at = index.to_local() if hasattr(index, "to_local") else index
        bl, nl = ql.shape[0], ql.shape[2]
        o = _decode_scores(ql.reshape(bl, kv_local, nl // kv_local, hd), kl.transpose(1, 2),
                           vl.transpose(1, 2), at, win, x.dtype)
        out = shd.from_local_like(o.reshape(bl, 1, nl, hd), like)[:, 0]
    y = _out_proj(out, p[prefix + "wo"], x.dtype)
    return y[:, None, :], k_cache, v_cache


def _decode_scores(qh, k_cache, v_cache, index, win, dtype):
    """One query row per (batch, head) of ``qh`` (B, K, G, hd) against the
    (B, K, T, hd) caches, the positions past ``index`` and outside the
    window masked -> (B, K, G, hd) in ``dtype``."""
    t, hd = k_cache.shape[2], qh.shape[-1]
    sc = torch.matmul(qh.float(), k_cache.float().transpose(-1, -2)) * hd ** -0.5
    tpos = torch.arange(t, device=qh.device)
    mask = (tpos <= index) & (index - tpos < win)
    sc = torch.where(mask[None, None, None, :], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    return torch.matmul(pr.to(dtype), v_cache.to(dtype))
