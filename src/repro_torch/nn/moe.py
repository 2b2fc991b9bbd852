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
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y, aux_loss)."""
    b, s, d = x.shape
    e = p["router"].shape[-1]
    logits = torch.matmul(x, p["router"].to(x.dtype))
    gates = torch.softmax(logits.float(), dim=-1)
    capacity = max(int(s * top_k * capacity_factor / e), 1)
    dispatch, combine, aux = _top_k_dispatch(gates, top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    xe = torch.einsum("bsec,bsd->becd", dispatch, x)
    h = act_fn(torch.einsum("becd,edf->becf", xe, p["we_gate"].to(x.dtype)))
    h = h * torch.einsum("becd,edf->becf", xe, p["we_up"].to(x.dtype))
    ye = torch.einsum("becf,efd->becd", h, p["we_down"].to(x.dtype))
    y = torch.einsum("becd,bsec->bsd", ye, combine)
    return y, aux.float()
