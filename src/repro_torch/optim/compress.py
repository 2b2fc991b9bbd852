"""Int8 gradient compression with error feedback (port of ``repro.optim.compress``).

Quantize a gradient tree to int8 with one float32 scale per tensor, carrying
the rounding residual into the next step (error feedback):

    state = ef_init(grads)
    q, scale, state = compress(grads, state)      # int8 codes + fp scales
    grads_hat = decompress(q, scale)

Trees are dicts of tensors, nested or flat.

``cross_pod_mean`` is the reference's ``shard_map`` psum over the ``pod``
axis as ``all_reduce`` over the mesh's ``pod`` group: each rank holds its
pod's gradients as plain tensors, the int8 codes cross the pod hop summed
in int32 and the scales as their maximum.  The reference's docstring names
a ``wrap_cross_pod`` that builds the ``shard_map``; the reference has no
such function, and the port has none either.
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


def cross_pod_mean(grads, ef_state, mesh):
    """Mean-reduce this rank's gradients across the mesh's ``pod`` axis
    with an int8 wire format.  Returns ``(mean, new error-feedback state)``.

    The int8 codes are summed in int32 (exact for <= 2^24 pods) with
    ``all_reduce(SUM)`` over ``mesh.get_group("pod")``, then rescaled by the
    largest of the pods' scales (``all_reduce(MAX)``) over the pod count."""
    import torch.distributed as dist

    n_pods = mesh.size(mesh.mesh_dim_names.index("pod"))
    group = mesh.get_group("pod")
    q, s, e = compress(grads, ef_state)

    def reduce_one(qq, ss):
        total = qq.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        smax = ss.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return total.float() * smax / n_pods

    return _map(reduce_one, q, s), e
