"""Adam/AdamW and cosine annealing with restarts (port of ``repro.optim.adam``).

Written by hand rather than with ``torch.optim.Adam``, whose bias correction
rounds differently from the reference's.  Parameters, gradients and the
moments are flat dicts keyed by the reference's ``/``-joined paths
(``l0/w0``, ``l1/q_out/f``), so the weight-decay mask matches the same
substrings as in the reference.  The step counter lives on the parameters'
device, as the reference's does, and the step-dependent scalars (bias
corrections, learning rate) are float32 tensors computed from it there, as
the reference computes them in float32: a step makes no CPU op and waits
for nothing, and a captured CUDA graph replays them with the counter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0


NO_DECAY_KEYS = ("norm", "bias", "_q", "q_in", "q_out", "bn_", "b0", "b_out",
                 "dt_bias", "a_log", "mu", "u_bonus", "ln_", "dec_pos")


def _decay_mask(path: str) -> float:
    return 0.0 if any(k in path for k in NO_DECAY_KEYS) else 1.0


def _f32(v, device=None) -> torch.Tensor:
    """A float32 scalar tensor on ``device``; a Python number is filled in
    there (a kernel, which a CUDA graph can capture, not a host copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=device)


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    device = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, leaves in path order."""
    sq = sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gn


def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                opt_state: dict, cfg: AdamConfig,
                lr_schedule: Optional[Callable] = None):
    """One AdamW step.  Returns ``(new_params, new_opt_state, metrics)``;
    nothing is updated in place."""
    step = opt_state["step"] + 1
    if cfg.clip_norm:
        grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gn = global_norm(grads)
    dev = step.device
    lr = _f32(cfg.lr, dev) if lr_schedule is None else _f32(lr_schedule(step), dev)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, dev), sf)
    bc2 = 1.0 - torch.pow(_f32(b2, dev), sf)
    new_p, new_m, new_v = {}, {}, {}
    for path, p in params.items():
        gf = grads[path].float()
        m2 = b1 * opt_state["m"][path] + (1 - b1) * gf
        v2 = b2 * opt_state["v"][path] + (1 - b2) * torch.square(gf)
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * _decay_mask(path) * p.float()
        new_p[path] = (p.float() - lr * delta).to(p.dtype)
        new_m[path], new_v[path] = m2, v2
    return new_p, {"m": new_m, "v": new_v, "step": step}, {
        "grad_norm": gn, "lr": lr}


def cosine_restarts(base_lr: float, first_period: int = 1000,
                    t_mult: int = 2, min_frac: float = 0.02,
                    warmup: int = 100) -> Callable:
    """SGDR: cosine annealing with (geometric) warm restarts + linear warmup;
    float32 arithmetic on a step tensor, as the reference, on the step's
    device."""

    def sched(step):
        sf = torch.as_tensor(step).to(torch.float32)
        tm = _f32(t_mult, sf.device)
        s = torch.clamp(sf - warmup, min=0.0)
        if t_mult == 1:
            frac = torch.remainder(s, first_period) / first_period
        else:
            cyc = torch.floor(torch.log2(1.0 + s * (t_mult - 1) / first_period)
                              / torch.log2(tm))
            start = first_period * (torch.pow(tm, cyc) - 1) / (t_mult - 1)
            length = first_period * torch.pow(tm, cyc)
            frac = (s - start) / length
        cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
        lr = base_lr * (min_frac + (1 - min_frac) * cos)
        wu = torch.clamp(sf / max(warmup, 1), 0.0, 1.0)
        return lr * wu

    return sched
