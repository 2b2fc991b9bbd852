"""Int8 gradient compression with error feedback (port of ``repro.optim.compress``).

Quantize a gradient tree to int8 with one float32 scale per tensor, carrying
the rounding residual into the next step (error feedback):

    state = ef_init(grads)
    q, scale, state = compress(grads, state)      # int8 codes + fp scales
    grads_hat = decompress(q, scale)

Trees are dicts of tensors, nested or flat.  The reference's
``cross_pod_mean`` (a ``shard_map`` psum over a pod mesh axis) waits for the
mesh slice (ROADMAP A9c).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _map(fn: Callable, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ef_init(grads):
    return _map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def _q_one(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.float() * scale
    return q, scale, new_err


def compress(grads, ef_state):
    """-> (int8 codes, float32 scales, new error-feedback state), each a tree
    shaped like ``grads``."""
    out = _map(_q_one, grads, ef_state)
    pick = lambda n: _map(lambda t: t[n], out) if isinstance(out, dict) else out[n]
    return pick(0), pick(1), pick(2)


def decompress(q, scales):
    return _map(lambda qq, ss: qq.float() * ss, q, scales)
