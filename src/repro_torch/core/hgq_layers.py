"""HGQ-quantized arithmetic layers, port of ``repro.core.hgq_layers``.

The "plain HGQ" layers of the paper's hybrids (§V-E, §V-F): ordinary dense
and conv layers whose weights and input activations pass through
heterogeneous fake-quantizers with trainable bit-widths, and whose resource
surrogate is the MAC-level EBOPs ``Σ bw_w · bw_a``.

The module keeps the reference's parameter keys and layouts: ``w`` is
``(C_in, C_out)``, ``b`` ``(C_out,)``, the weight quantizer ``q_w`` per
element ``(C_in, C_out)`` and the activation quantizer ``q_a`` per channel
``(C_in,)``.  Both quantizers are :func:`core.quant.fake_quant`, so kernel
B1 on the card.  ``xq @ wq`` is ``torch.matmul``, as the reference computes
it outside any kernel; callers switch TF32 off so it runs in full float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.ebops import ebops_mac
from repro_torch.core.lut_layers import _quantizer, im2col_1d
from repro_torch.core.quant import QuantConfig, bitwidth, fake_quant
from repro_torch.nn.base import Aux

QW_DEFAULT = QuantConfig(granularity="element", signed=True, overflow="SAT",
                         init_f=6.0, init_i=1.0)
QA_DEFAULT = QuantConfig(granularity="channel", signed=True, overflow="SAT",
                         init_f=6.0, init_i=3.0)


class HGQDense(nn.Module):
    """HGQ dense layer; ``forward(x) -> (y, Aux)`` in the module's train or
    eval mode (eval after construction).  ``w`` is drawn from ``generator``
    on the generator's device and moved to ``device``."""

    def __init__(self, c_in: int, c_out: int, use_bias: bool = True,
                 activation: Optional[str] = None,
                 q_w: QuantConfig = QW_DEFAULT, q_a: QuantConfig = QA_DEFAULT,
                 *, device="cuda", generator: torch.Generator):
        super().__init__()
        if activation not in (None, "relu", "tanh"):
            raise ValueError(f"unknown activation {activation!r}")
        self.c_in, self.c_out = c_in, c_out
        self.use_bias, self.activation = use_bias, activation
        self.cfg_w, self.cfg_a = q_w, q_a
        w = torch.randn((c_in, c_out), generator=generator, device=generator.device)
        self.w = nn.Parameter(w.to(device) * c_in ** -0.5)
        self.q_w = _quantizer(q_w, (c_in, c_out), device)
        self.q_a = _quantizer(q_a, (c_in,), device)
        if use_bias:
            self.b = nn.Parameter(torch.zeros(c_out, device=device))
        self.train(False)

    def forward(self, x: torch.Tensor, *, fused: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Aux]:
        """``fused`` is accepted for a uniform layer call and ignored: the
        reference has no fused kernel for this layer."""
        train = self.training
        xq = fake_quant(self.q_a, x, self.cfg_a, train=train)
        wq = fake_quant(self.q_w, self.w, self.cfg_w, train=train)
        y = torch.matmul(xq, wq)
        if self.use_bias:
            y = y + self.b
        if self.activation == "relu":
            y = torch.relu(y)
        elif self.activation == "tanh":
            y = torch.tanh(y)
        eb = ebops_mac(bitwidth(self.q_w, self.cfg_w), bitwidth(self.q_a, self.cfg_a))
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        return y, Aux(ebops=eb, aux_loss=zero)


class HGQConv1D(nn.Module):
    """im2col + a ``dense`` :class:`HGQDense` over ``kernel*C_in`` inputs,
    mirroring ``LUTConv1D`` so hybrids swap layer types 1:1."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: str = "VALID", use_bias: bool = True,
                 activation: Optional[str] = None,
                 q_w: QuantConfig = QW_DEFAULT, q_a: QuantConfig = QA_DEFAULT,
                 *, device="cuda", generator: torch.Generator):
        super().__init__()
        self.c_in, self.c_out, self.kernel = c_in, c_out, kernel
        self.stride, self.padding = stride, padding
        self.use_bias, self.activation = use_bias, activation
        self.dense = HGQDense(c_in * kernel, c_out, use_bias, activation, q_w,
                              q_a, device=device, generator=generator)
        self.train(False)

    def forward(self, x: torch.Tensor, *, fused: Optional[bool] = None):
        patches = im2col_1d(x, self.kernel, self.stride, self.padding)
        return self.dense(patches, fused=fused)
