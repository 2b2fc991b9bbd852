"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are what the kernels are held against: the CPU tests run them, and
``chip_smoke.py`` compares each CUDA kernel with them on the card.  Bit-width
arrays are already-rounded integers carried as float tensors, so the plain
version and the kernel share one definition of the quantization grid.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import _fq_eval


def fake_quant_ref(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
                   signed: bool, overflow: str) -> torch.Tensor:
    """Fixed-point projection with integer (f, i) bit-width tensors."""
    x = x.float()
    f = torch.broadcast_to(f, x.shape).float()
    i = torch.broadcast_to(i, x.shape).float()
    return _fq_eval(x, f, i, signed, overflow)


def lut_dense_ref(
    x: torch.Tensor,      # (B, C_in)
    w0: torch.Tensor,     # (C_in, H, C_out)
    b0: torch.Tensor,     # (C_in, H, C_out)
    w_out: torch.Tensor,  # (C_in, H, C_out)
    b_out: torch.Tensor,  # (C_in, C_out)
    f_in: torch.Tensor,   # (C_in, C_out) widths of the WRAP input quantizer
    i_in: torch.Tensor,
    f_out: torch.Tensor,  # (C_in, C_out) widths of the SAT output quantizer
    i_out: torch.Tensor,
) -> torch.Tensor:
    """Eval-mode LUT-Dense forward (Eq. 1), one hidden tanh layer.

    ``out[b, o] = Σ_j SAT(Σ_h w_out·tanh(WRAP(x[b, j])·w0 + b0) + b_out)``.
    The sum over ``h`` is taken in index order, one element-wise add at a
    time, which is the order the CUDA kernel uses: the two then differ only
    where their ``tanh`` differs.
    """
    b, c_in = x.shape
    c_out = w0.shape[-1]
    xb = x.float()[:, :, None].expand(b, c_in, c_out)
    xq = fake_quant_ref(xb, f_in[None], i_in[None], True, "WRAP")
    h = torch.tanh(xq[:, :, None, :] * w0[None] + b0[None])       # (B, Ci, H, Co)
    p = h * w_out[None]
    y = p[:, :, 0]
    for k in range(1, p.shape[2]):
        y = y + p[:, :, k]
    y = y + b_out[None]                                            # (B, Ci, Co)
    yq = fake_quant_ref(y, f_out[None], i_out[None], True, "SAT")
    return torch.sum(yq, dim=1)                                    # (B, Co)
