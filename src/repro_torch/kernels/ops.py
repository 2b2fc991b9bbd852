"""Public kernel entry points and launch counters (port of ``repro.kernels.ops``).

``lut_dense``        the LUT-Dense forward with already-rounded (integer-
                     valued) bit-width tensors, as an ``autograd.Function``:
                     kernel B2 forward and kernel B3 backward on CUDA
                     tensors, their plain versions on CPU tensors.  Its
                     backward gives the surrogate gradients of
                     ``(f_in, f_out, i_out)`` and an exact zero for ``i_in``
                     (WRAP).
``lut_dense_train``  takes the continuous bit-width parameters, applies the
                     clip + ``round_ste`` chain of ``core.quant.ste_bits`` and
                     calls ``lut_dense``.
``lut_bn_stats``     train-mode batch-norm's batch statistics of the cell
                     outputs, as an ``autograd.Function``: each cell's mean
                     and population variance over the batch
                     (``lut_bn_stats_kernel``), and their backward, a
                     recompute kernel (``lut_bn_stats_grad_kernel``); their
                     plain versions on CPU tensors.
``fake_quant``       kernel B1 (``kernels/fake_quant.py``).

``launch_counts`` / ``reset_launch_counts`` read and clear the per-kernel
launch counters (``repro_torch/tracing.py``), so a run can show that its
main path went through the kernels and not their plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fake_quant import fake_quant_fused
from repro_torch.kernels.lut_dense import lut_bn_stats_fused, lut_dense_fused
from repro_torch.kernels.lut_dense_bwd import lut_bn_stats_grad_fused, lut_dense_bwd_fused
from repro_torch.tracing import launch_counts  # noqa: F401
from repro_torch.tracing import reset_launches as reset_launch_counts  # noqa: F401


class _LUTDenseFn(torch.autograd.Function):
    """B2 forward, B3 recompute backward (``repro.kernels.ops.lut_dense``)."""

    @staticmethod
    def forward(ctx, x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
        ctx.save_for_backward(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)
        return lut_dense_fused(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        dx, dw0, db0, dwo, dbo, dfi, dfo, dio = lut_dense_bwd_fused(
            *saved, g.contiguous())
        # i_in has no surrogate under WRAP (core.quant._fq_bwd gives 0 there)
        return dx, dw0, db0, dwo, dbo, dfi, torch.zeros_like(saved[6]), dfo, dio


def lut_dense(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
    """Fused LUT-Dense; shapes as ``ref.lut_dense_ref``, widths integer-valued."""
    return _LUTDenseFn.apply(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)


class _BNStatsFn(torch.autograd.Function):
    """Batch statistics of the raw cell outputs, and their recompute backward."""

    @staticmethod
    def forward(ctx, x, w0, b0, w_out, b_out, f_in, i_in):
        mean, var = lut_bn_stats_fused(x, w0, b0, w_out, b_out, f_in, i_in)
        ctx.save_for_backward(x, w0, b0, w_out, b_out, f_in, i_in, mean)
        return mean, var

    @staticmethod
    def backward(ctx, g_mean, g_var):
        saved = ctx.saved_tensors
        grads = lut_bn_stats_grad_fused(*saved, g_mean.contiguous(), g_var.contiguous())
        # i_in has no surrogate under WRAP
        return (*grads, torch.zeros_like(saved[6]))


def lut_bn_stats(x, w0, b0, w_out, b_out, f_in, i_in):
    """``(mean, var)``, each (C_in, C_out): every cell's mean and population
    variance over the batch of ``x`` (B, C_in) of its output before the
    output quantizer; shapes as ``lut_dense`` without the output widths.
    Gradients reach every input as through the cells' einsum path, the
    input widths' by the WRAP surrogate."""
    return _BNStatsFn.apply(x, w0, b0, w_out, b_out, f_in, i_in)


def lut_dense_train(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, *,
                    clip_in=None, clip_out=None):
    """Train-mode fused LUT-Dense with continuous bit-width tensors.

    ``clip_in``/``clip_out`` are optional ``((min_f, max_f), (min_i, max_i))``
    bounds; the clip + STE-round chain is ``core.quant.ste_bits`` itself, so
    the gradients reach the bit-width tensors as through ``fake_quant``.
    """
    from repro_torch.core.quant import QuantConfig, ste_bits

    inf = float("inf")

    def bits(f, i, clip):
        (mf, xf), (mi, xi) = clip if clip is not None else ((-inf, inf), (-inf, inf))
        return ste_bits({"f": f, "i": i},
                        QuantConfig(min_f=mf, max_f=xf, min_i=mi, max_i=xi))

    f_in, i_in = bits(f_in, i_in, clip_in)
    f_out, i_out = bits(f_out, i_out, clip_out)
    return lut_dense(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)


def fake_quant(x, f, i, *, signed: bool = True, overflow: str = "SAT"):
    """Fake-quant with integer-valued widths: kernel B1 on a CUDA tensor."""
    return fake_quant_fused(x, f, i, signed=signed, overflow=overflow)
