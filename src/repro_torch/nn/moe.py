"""Mixture-of-Experts with GShard-style static dispatch (port of ``repro.nn.moe``).

Capacity-based dispatch as dense einsums with one-hot masks, every shape
static; top-k routing (k rounds of argmax, one-hot and cumsum) with a
capacity per expert, a GShard load-balance auxiliary loss, and arctic's
dense-residual branch added by the caller (``models/lm.py``).  The one-hot
masks are comparisons with an ``arange`` rather than ``F.one_hot``, which
checks its range on the host (a device sync) and rejects an out-of-range
slot that ``jax.nn.one_hot`` maps to a zero row (a token past capacity).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.nn.params import PDef
from repro_torch.parallel.sharding import dense, grad_like


def moe_defs(n_layers: int, d: int, d_ff: int, n_experts: int) -> dict:
    L, E = n_layers, n_experts
    return {
        "router": PDef((L, d, E), ("layers", "embed", None), scale=0.1),
        "we_gate": PDef((L, E, d, d_ff), ("layers", "experts", "embed", "ffn")),
        "we_up": PDef((L, E, d, d_ff), ("layers", "experts", "embed", "ffn")),
        "we_down": PDef((L, E, d_ff, d), ("layers", "experts", "ffn", "embed")),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for an index outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_dispatch(gates: torch.Tensor, k: int, capacity: int):
    """gates (B, S, E) -> dispatch/combine (B, S, E, C) + load-balance loss."""
    b, s, e = gates.shape
    orig = gates
    dispatch = torch.zeros((b, s, e, capacity), dtype=gates.dtype, device=gates.device)
    combine = torch.zeros_like(dispatch)
    # running count of tokens already routed to each expert (per batch row)
    base = torch.zeros((b, 1, e), dtype=torch.int32, device=gates.device)
    for _ in range(k):
        idx = torch.argmax(gates, dim=-1)                          # (B, S)
        onehot = _one_hot(idx, e, gates.dtype)                     # (B, S, E)
        oh_i = onehot.to(torch.int32)
        gate_k = torch.sum(gates * onehot, dim=-1)                 # (B, S)
        # position of each token within its expert queue
        pos = torch.cumsum(oh_i, dim=1, dtype=torch.int32) - 1 + base
        base = base + torch.sum(oh_i, dim=1, keepdim=True, dtype=torch.int32)
        my_pos = torch.sum(pos * oh_i, dim=-1, dtype=torch.int32)  # (B, S)
        keep = my_pos < capacity
        poh = _one_hot(my_pos, capacity, gates.dtype)              # (B, S, C)
        sel = onehot * keep[..., None].to(gates.dtype)
        dispatch = dispatch + sel[..., None] * poh[..., None, :]
        combine = combine + (gate_k[..., None] * sel)[..., None] * poh[..., None, :]
        gates = gates * (1.0 - onehot)                             # mask chosen
    # GShard load-balance loss on the *first* choice distribution
    me = torch.mean(orig, dim=(0, 1))                              # (E,)
    ce = torch.mean(dispatch.sum(-1), dim=(0, 1))                  # fraction routed
    aux = e * torch.sum(me * ce)
    return dispatch, combine, aux


def moe_apply(p: dict, x: torch.Tensor, act_fn, *, top_k: int,
              capacity_factor: float, constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux_loss).  On a mesh (``constrain`` given) the
    dispatch tensors are constrained to (batch, -, model, -) and the
    per-expert activations to (batch, model, -, -): experts shard over
    ``model`` (EP)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    # the routing chain's gradient comes back sharded wherever DTensor put
    # the dispatch einsums; placed like the logits before the matmul (C18)
    logits = grad_like(torch.matmul(x, p["router"].to(x.dtype)))
    gates = torch.softmax(logits.float(), dim=-1)
    capacity = max(int(s * top_k * capacity_factor / e), 1)
    dispatch, combine, aux = _top_k_dispatch(gates, top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    if constrain is not None:  # (batch, -, model/EP, -)
        dispatch = constrain(dispatch, "batch", None, "model", None)
        combine = constrain(combine, "batch", None, "model", None)

    local = _experts_on_shards(p, x, dispatch, combine, act_fn) if constrain else None
    if local is not None:
        return local, aux.float()
    xe = dense(torch.einsum("bsec,bsd->becd", dense(dispatch), dense(x)))
    if constrain is not None:
        xe = constrain(xe, "batch", "model", None, None)
    xe = dense(xe)
    h = act_fn(dense(torch.einsum("becd,edf->becf", xe, p["we_gate"].to(x.dtype))))
    h = dense(h * dense(torch.einsum("becd,edf->becf", xe, p["we_up"].to(x.dtype))))
    ye = dense(torch.einsum("becf,efd->becd", h, p["we_down"].to(x.dtype)))
    if constrain is not None:
        ye = constrain(ye, "batch", "model", None, None)
    y = dense(torch.einsum("becd,bsec->bsd", dense(ye), dense(combine)))
    return y, aux.float()


def _expert_ffn(x, dispatch, combine, wg, wu, wd, act_fn):
    """Dispatch, the experts' GLU and combine: (B, S, D) -> (B, S, D)."""
    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    h = act_fn(torch.einsum("becd,edf->becf", xe, wg))
    h = h * torch.einsum("becd,edf->becf", xe, wu)
    ye = torch.einsum("becf,efd->becd", h, wd)
    return torch.einsum("becd,bsec->bsd", ye, combine)


def _experts_on_shards(p, x, dispatch, combine, act_fn):
    """The experts on each rank's shards, or None where the placements do
    not allow it (the DTensor ops then run).

    Allowed: ``x`` sharded at most along the batch (a pending sum made
    replicated first), ``dispatch`` and ``combine`` alike along the batch
    and along the experts (EP) and nowhere else.  Each rank then holds its
    rows' tokens and its experts' slots: it gathers its experts' weights
    whole along every other mesh dim (ZeRO's gather), runs the experts on
    its shards, and its output (and the gradient of ``x``) is a pending
    sum over the expert shards.  The weights' gradients sum over the batch
    shards.  No DTensor op runs
    inside the experts (ROADMAP C18)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not all(isinstance(t, DTensor) for t in (x, dispatch, combine)):
        return None
    mesh = x.device_mesh
    xp = [Replicate() if q.is_partial() else q for q in x.placements]
    dp = list(dispatch.placements)
    if list(combine.placements) != dp:
        return None
    for a, b in zip(xp, dp):
        if (a.is_shard() and a.dim != 0) or a.is_shard(0) != b.is_shard(0):
            return None
        if b.is_partial() or (b.is_shard() and b.dim not in (0, 2)):
            return None
    if xp != list(x.placements):
        x = x.redistribute(mesh, xp)
    wp = [Shard(0) if b.is_shard(2) else Replicate() for b in dp]
    gp = [Partial() if a.is_shard(0) else w for a, w in zip(xp, wp)]
    ws = []
    for name in ("we_gate", "we_up", "we_down"):
        w = p[name].to(x.dtype)
        w = w if list(w.placements) == wp else w.redistribute(mesh, wp)
        ws.append(w.to_local(grad_placements=gp))
    # x's gradient, like the output, is a sum over the expert shards
    yp = [Partial() if b.is_shard(2) else a for a, b in zip(xp, dp)]
    y = _expert_ffn(x.to_local(grad_placements=yp), dispatch.to_local(), combine.to_local(),
                    *ws, act_fn)
    return DTensor.from_local(y, mesh, yp, run_check=False)
