"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

These are what the kernels are held against: the CPU tests run them, and
``chip_smoke.py`` compares each CUDA kernel with them on the card.  Bit-width
arrays are already-rounded integers carried as float tensors, so the plain
version and the kernel share one definition of the quantization grid.
"""

from __future__ import annotations

import torch

from repro_torch.core.quant import LOG2, _fq_eval, fq_surrogate, pow2


def fake_quant_ref(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
                   signed: bool, overflow: str) -> torch.Tensor:
    """Fixed-point projection with integer (f, i) bit-width tensors."""
    x = x.float()
    for w in (f, i):
        torch.broadcast_to(w, x.shape)            # raises unless w broadcasts to x
    # the grid's powers of two are formed at the widths' own size
    return _fq_eval(x, f.float(), i.float(), signed, overflow)


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
    y = _sum_hidden(h * w_out[None]) + b_out[None]                 # (B, Ci, Co)
    yq = fake_quant_ref(y, f_out[None], i_out[None], True, "SAT")
    return torch.sum(yq, dim=1)                                    # (B, Co)


def _sum_hidden(p: torch.Tensor) -> torch.Tensor:
    """Σ over axis 2 of (B, C_in, H, C_out), one add at a time in index order."""
    y = p[:, :, 0]
    for k in range(1, p.shape[2]):
        y = y + p[:, :, k]
    return y


def lut_dense_train_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
    """Differentiable train-mode oracle of the fused forward/backward pair.

    The math of :func:`lut_dense_ref` built from ``core.quant.fq_surrogate``,
    so autograd through it gives the surrogate gradients of all five weight
    tensors and the four (integer-valued) bit-width tensors.  It holds the
    (B, C_in, H, C_out) hidden tensor in memory; it is an oracle, not a
    fast path.
    """
    b, c_in = x.shape
    xb = x.float()[:, :, None].expand(b, c_in, w0.shape[-1])
    xq = fq_surrogate(xb, f_in, i_in, signed=True, overflow="WRAP")
    h = torch.tanh(xq[:, :, None, :] * w0[None] + b0[None])
    y = _sum_hidden(h * w_out[None]) + b_out[None]
    yq = fq_surrogate(y, f_out, i_out, signed=True, overflow="SAT")
    return torch.sum(yq, dim=1).to(x.dtype)


def lut_dense_bwd_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g):
    """Plain version of kernel B3: the recompute backward of the eval forward.

    Shapes as :func:`lut_dense_ref` plus the cotangent ``g`` (B, C_out).
    Returns ``(dx, dw0, db0, dw_out, db_out, df_in, df_out, di_out)``, the
    gradients of :func:`lut_dense_train_ref`; ``di_in`` is identically zero
    under WRAP and left to the caller.
    """
    b, c_in = x.shape
    c_out = w0.shape[-1]
    xb = x.float()[:, :, None].expand(b, c_in, c_out)
    # forward recompute, the expressions of lut_dense_ref, on the exact
    # powers of two of its quantizers (pow2, as kernel B3)
    scale_i = pow2(-f_in)
    r_in = torch.round(xb / scale_i) * scale_i
    alive_i = f_in + i_in + 1.0 > 0.0
    xq = fake_quant_ref(xb, f_in[None], i_in[None], True, "WRAP")
    h = torch.tanh(xq[:, :, None, :] * w0[None] + b0[None])       # (B, Ci, H, Co)
    y = _sum_hidden(h * w_out[None]) + b_out[None]                 # (B, Ci, Co)
    scale_o = pow2(-f_out)
    r_out = torch.round(y / scale_o) * scale_o
    p2 = pow2(i_out)
    chi = r_out > p2 - scale_o
    clo = r_out < -p2
    alive_o = f_out + i_out + 1.0 > 0.0
    zero = torch.zeros_like(y)
    gb = g.float()[:, None, :].expand_as(y)
    # SAT output-quantizer surrogate (core.quant._fq_bwd)
    gy = torch.where(alive_o & ~(chi | clo), gb, zero)
    dfo_s = torch.where(chi, LOG2 * scale_o, LOG2 * (y - r_out))
    dfo_s = torch.where(clo, zero, dfo_s)
    dio_s = torch.where(chi, LOG2 * p2, torch.where(clo, -LOG2 * p2, zero))
    df_out = torch.sum(torch.where(alive_o, dfo_s * gb, zero), dim=0)
    di_out = torch.sum(torch.where(alive_o, dio_s * gb, zero), dim=0)
    # the tiny-MLP VJP
    db_out = torch.sum(gy, dim=0)
    gy4 = gy[:, :, None, :]
    dw_out = torch.sum(h * gy4, dim=0)
    gz = gy4 * w_out[None] * (1.0 - h * h)                         # (B, Ci, H, Co)
    db0 = torch.sum(gz, dim=0)
    dw0 = torch.sum(gz * xq[:, :, None, :], dim=0)
    gxq = _sum_hidden(gz * w0[None])                               # (B, Ci, Co)
    # WRAP input-quantizer surrogate
    df_in = torch.sum(torch.where(alive_i, LOG2 * (xb - r_in) * gxq, zero), dim=0)
    gx = torch.where(alive_i, gxq, zero)
    dx = gx[:, :, 0]
    for o in range(1, c_out):
        dx = dx + gx[:, :, o]
    return dx, dw0, db0, dw_out, db_out, df_in, df_out, di_out
