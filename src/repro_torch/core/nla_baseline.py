"""NLA-style LUT-aware-training baseline (port of
``repro.core.nla_baseline``; paper §II / §III-A bottleneck model).

NeuraLUT-Assemble replaces neurons with *high-fan-in* L-LUTs assembled into
trees: each output is a tree of F-input L-LUTs, every L-LUT realised during
training as a comparatively wide/deep MLP, and the input mappings are
*learned*, implemented with dynamic gathers.  The paper names these two
choices (wide per-LUT MLPs, irregular gathers) as the training-speed
bottlenecks HGQ-LUT removes.

Per output neuron: a two-level tree of ⌈C_in/F⌉ leaf L-LUTs and one root
L-LUT, each a width-64 depth-2 MLP, fed through ``index_select`` gather
mappings with straight-through trainable selection.  The reference computes
all of it with plain ``jnp`` ops (no Pallas kernel), and so does the port:
plain PyTorch gathers and einsums.

The module keeps the reference's parameter keys and shapes: ``map_logits``
(n_leaf, F, C_in), ``leaf/{w0, b0, w1, b1, w_out, b_out}`` and ``root/...``
with the same keys (``interop.nla_params_from_numpy`` carries them across).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.nn.base import Aux


def _mlp_defs(n: int, fan_in: int, width: int, depth: int, *, device,
              generator: torch.Generator) -> nn.ParameterDict:
    """``n`` independent ``fan_in -> width (x depth) -> 1`` tanh MLPs."""

    def normal(*shape):
        t = torch.randn(shape, generator=generator, device=generator.device)
        return t.to(device)

    params = {}
    d_prev = fan_in
    for l in range(depth):
        params[f"w{l}"] = normal(n, d_prev, width) * d_prev ** -0.5
        params[f"b{l}"] = torch.zeros(n, width, device=device)
        d_prev = width
    params["w_out"] = normal(n, d_prev) * d_prev ** -0.5
    params["b_out"] = torch.zeros(n, device=device)
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})


def _mlp_apply(p: nn.ParameterDict, x: torch.Tensor, depth: int) -> torch.Tensor:
    """x (..., n, fan_in) -> (..., n) through the per-LUT MLPs."""
    h = x
    for l in range(depth):
        h = torch.tanh(torch.einsum("...nf,nfh->...nh", h, p[f"w{l}"]) + p[f"b{l}"])
    return torch.einsum("...nh,nh->...n", h, p["w_out"]) + p["b_out"]


class NLALayer(nn.Module):
    """One NLA-style layer: per output, a tree of ``fan_in``-input L-LUTs.

    ``forward(x) -> (y, Aux)``; the layer has no train/eval difference and
    costs no EBOPs.  Weights are drawn from ``generator`` on its device and
    then moved to ``device``, so one seed gives one set of weights on every
    device.
    """

    def __init__(self, c_in: int, c_out: int, fan_in: int = 6, mlp_width: int = 64,
                 mlp_depth: int = 2, *, device="cuda",
                 generator: torch.Generator = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator()
        self.c_in, self.c_out, self.fan_in = c_in, c_out, fan_in
        self.mlp_width, self.mlp_depth = mlp_width, mlp_depth
        n_leaf = c_out * self.n_leaves
        logits = torch.randn((n_leaf, fan_in, c_in), generator=generator,
                             device=generator.device) * 0.1
        # learned mapping logits: which inputs feed each leaf L-LUT
        self.map_logits = nn.Parameter(logits.to(device))
        self.leaf = _mlp_defs(n_leaf, fan_in, mlp_width, mlp_depth,
                              device=device, generator=generator)
        self.root = _mlp_defs(c_out, self.n_leaves, mlp_width, mlp_depth,
                              device=device, generator=generator)

    @property
    def n_leaves(self) -> int:
        return -(-self.c_in // self.fan_in)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Aux]:
        n_leaf = self.c_out * self.n_leaves
        # hard selection via argmax of the mapping logits (the first maximum,
        # as jnp.argmax), realised as a dynamic gather: the irregular-access
        # pattern the paper calls out
        idx = torch.argmax(self.map_logits, dim=-1)                # (n_leaf, F)
        gathered = torch.index_select(x, -1, idx.reshape(-1))
        hard = gathered.reshape(x.shape[:-1] + (n_leaf, self.fan_in))
        # straight-through: the mapping logits get their gradient through the
        # softmax path only
        soft = torch.einsum("...i,nfi->...nf", x, torch.softmax(self.map_logits, -1))
        h = (hard - soft).detach() + soft
        leaf_out = _mlp_apply(self.leaf, h, self.mlp_depth)        # (..., n_leaf)
        tree_in = leaf_out.reshape(x.shape[:-1] + (self.c_out, self.n_leaves))
        y = _mlp_apply(self.root, tree_in, self.mlp_depth)         # (..., c_out)
        return y, Aux.zero(x.device)
