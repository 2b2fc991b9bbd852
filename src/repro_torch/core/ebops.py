"""EBOPs LUT surrogate, Eq. (5) of the paper (port of ``repro.core.ebops``).

An L-LUT with an ``m``-bit input and ``n``-bit output on LUT-X primitives
(splittable into ``2**(X-Y)`` LUT-Y's) costs ``2**(m-X) * n`` when
``m >= Y`` and ``(m/Y) * 2**(Y-X) * n`` otherwise; 0-width inputs or outputs
cost nothing.  The MAC surrogate and the β schedule wait for the training
slice.
"""

from __future__ import annotations

import torch

# LUT-6 splittable into two LUT-5s (Xilinx 7-series / UltraScale+).
LUT_X = 6
LUT_Y = 5


def ebops_lut(m_bits: torch.Tensor, n_bits: torch.Tensor,
              x: int = LUT_X, y: int = LUT_Y) -> torch.Tensor:
    """Eq. (5) summed over broadcast ``(m, n)`` cell widths."""
    m = torch.clamp(m_bits, min=0.0)
    n = torch.clamp(n_bits, min=0.0)
    wide = torch.exp2(m - x) * n
    narrow = (m / y) * (2.0 ** (y - x)) * n
    cost = torch.where(m >= y, wide, narrow)
    return torch.sum(torch.where((m > 0) & (n > 0), cost, torch.zeros_like(cost)))
