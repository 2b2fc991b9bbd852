"""Truth-table extraction for trained LUT layers (paper §IV-B), port of
``repro.core.tables``.

After training, every L-LUT_{i,j} of a LUT-Dense layer becomes a physical
truth table: all ``2**m`` quantized input codes are enumerated through the
cell MLP (+ fused batch-norm) and the result is quantized with the cell's SAT
output quantizer.  All cells of a layer are enumerated in one batched pass.

:class:`LayerTables` is the hardware artifact: integer code in, integer code
out, per-cell fixed-point formats.  It is numpy and identical to the
reference's, so programs cross between the packages as plain arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lut_layers import LUTDense
from repro_torch.core.quant import int_bits, int_to_float, quantize_to_int


@dataclasses.dataclass
class LayerTables:
    """Truth tables of one LUT-Dense layer.

    ``codes`` is laid out ``(j, i, e)`` — input channel ``j`` (axis 0, size
    ``C_in``), output channel ``i`` (axis 1, size ``C_out``), table entry
    ``e`` (axis 2, size ``2**max_m``).  ``codes[j, i, e]`` is the signed
    output code of L-LUT_{i,j} for input index ``e``; entries with
    ``e >= 2**in_width[j, i]`` are padding (never addressed).

    WRAP two's-complement indexing contract
    ---------------------------------------
    The input quantizer of every cell is WRAP, so the table index for an
    input code ``c`` (an int on the cell's ``f_in[j, i]`` grid, possibly
    negative) is the two's-complement re-interpretation of its low
    ``m = in_width[j, i]`` bits::

        idx = c mod 2**m            (== c & (2**m - 1); 0 <= idx < 2**m)

    Pruned cells (``m <= 0``) have a single entry addressed with ``idx = 0``
    (``entry_sizes`` reports size 1 for them) and emit code 0.  This is the
    single definition of the indexing scheme; :meth:`lookup_codes`, the DAIS
    interpreter's ``LLUT`` op (``core/dais.py``), the Verilog case functions
    (``core/rtl.py``) and the serving engine's batched gathers
    (``kernels/lut_serve.py``, ``csrc/lut_serve.cu``) all implement exactly
    this contract.
    """

    f_in: np.ndarray      # (C_in, C_out) int32 — [j, i] like every grid below
    i_in: np.ndarray      # (C_in, C_out) int32
    f_out: np.ndarray     # (C_in, C_out) int32
    i_out: np.ndarray     # (C_in, C_out) int32
    in_width: np.ndarray  # (C_in, C_out) int32, m = f_in + i_in + 1 (signed), >= 0
    out_width: np.ndarray  # (C_in, C_out) int32, n = f_out + i_out + 1, >= 0
    codes: np.ndarray     # (C_in, C_out, 2**max_m) int64, indexed [j, i, e]

    @property
    def c_in(self) -> int:
        return self.codes.shape[0]

    @property
    def c_out(self) -> int:
        return self.codes.shape[1]

    def n_luts(self) -> int:
        """Number of live (non-pruned) L-LUTs."""
        return int(np.sum((self.in_width > 0) & (self.out_width > 0)))

    def entry_sizes(self) -> np.ndarray:
        """(C_in, C_out) addressable table sizes: ``2**m`` live, 1 pruned.

        The WRAP index of an input code ``c`` at cell (j, i) is
        ``c mod entry_sizes()[j, i]`` — see the class docstring for the full
        two's-complement indexing contract.
        """
        return np.where(self.in_width > 0,
                        2 ** np.maximum(self.in_width, 0), 1).astype(np.int64)

    # ------------------------------------------------------------------ use
    def lookup_codes(self, x_codes: np.ndarray, x_f: np.ndarray) -> np.ndarray:
        """Bit-exact layer evaluation on integer input codes, in numpy.

        ``x_codes``: (..., C_in) int64 codes on a grid with fractional bits
        ``x_f`` (scalar or (C_in,), broadcast over output channels).  Returns
        output codes (..., C_out) on the *common* output grid with fractional
        bits ``self.common_f_out()``.
        """
        ci = self.c_in
        xf = np.broadcast_to(np.asarray(x_f, np.int64), (ci,))
        # requantize input j to cell (j, i)'s grid: f_in[j, i] - x_f[j] bits
        shift = self.f_in - xf[:, None]                     # (ci, co)
        x = x_codes[..., :, None].astype(np.float64)        # (..., ci, 1)
        scaled = np.round(x * np.exp2(shift))               # (..., ci, co)
        idx = np.mod(scaled, self.entry_sizes()).astype(np.int64)  # the WRAP contract
        out = np.take_along_axis(
            np.broadcast_to(self.codes, x_codes.shape[:-1] + self.codes.shape),
            idx[..., None], axis=-1)[..., 0]                # (..., ci, co)
        # align heterogeneous per-cell output grids to the common grid; F is
        # the max over LIVE cells, so clamp the (value-irrelevant, codes==0)
        # shift of pruned cells whose f_out may exceed it
        F = self.common_f_out()
        out = out * (2 ** np.maximum(F - self.f_out, 0).astype(np.int64))
        return out.sum(axis=-2)                             # Σ over C_in

    def common_f_out(self) -> int:
        live = (self.in_width > 0) & (self.out_width > 0)
        return int(self.f_out[live].max()) if live.any() else 0

    def gather_params(self, x_f):
        """``(in_shift, mask, out_shift)`` for batched-gather evaluation.

        The one derivation shared by every gather-style backend (the fused
        serving stage and the packed chain): requantize input ``j`` onto cell
        ``(j, i)``'s grid with ``in_shift = f_in - x_f``, index with the
        WRAP ``mask = entry_sizes() - 1``, then align heterogeneous output
        grids with ``out_shift = max(common_f_out() - f_out, 0)`` — the
        clamp matters because a *pruned* cell (codes all 0) may keep an
        ``f_out`` above the common grid of the live cells.
        """
        xf = np.broadcast_to(np.asarray(x_f, np.int64), (self.c_in,))
        in_shift = (self.f_in - xf[:, None]).astype(np.int64)
        mask = (self.entry_sizes() - 1).astype(np.int64)
        out_shift = np.maximum(self.common_f_out() - self.f_out,
                               0).astype(np.int64)
        return in_shift, mask, out_shift


def extract_tables(layer) -> LayerTables:
    """Enumerate all input codes of every cell through the layer's MLPs.

    Accepts ``LUTDense`` or a conv wrapper through its ``dense`` view
    (``LUTConv1D/2D``): a convolution's cells are its dense equivalent's
    ``(kernel*C_in, C_out)`` grid, extracted once and shared by every
    spatial site of the lowered program.  The MLP runs in float32 on the
    layer's device, the same function the eval forward evaluates, so the
    tables reproduce that forward exactly.
    """
    if not isinstance(layer, LUTDense):
        dense = getattr(layer, "dense", None)
        if not isinstance(dense, LUTDense):
            raise TypeError(f"cannot extract truth tables from {type(layer)}")
        layer = dense
    f_in, i_in = int_bits(layer.q_in, layer.cfg_in)
    f_out, i_out = int_bits(layer.q_out, layer.cfg_out)
    k_in = 1 if layer.cfg_in.signed else 0
    k_out = 1 if layer.cfg_out.signed else 0
    m = np.maximum(f_in + i_in + k_in, 0)
    n = np.maximum(f_out + i_out + k_out, 0)
    max_m = int(m.max()) if m.size else 0
    n_entries = max(2 ** max_m, 1)

    # Input value for entry e of cell (j, i): interpret e as an m-bit
    # two's-complement code on the (f_in, i_in) grid.
    e = np.arange(n_entries, dtype=np.int64)[:, None, None]     # (E, 1, 1)
    size = np.where(m > 0, 2 ** m, 1)[None]                     # (1, ci, co)
    code = np.mod(e, size)
    if layer.cfg_in.signed:
        half = size // 2
        code = np.where(code >= half, code - size, code)
    x = int_to_float(code, f_in[None])                          # (E, ci, co)

    device = layer.w0.device
    with torch.no_grad():
        y = layer.cell_mlp(torch.as_tensor(x, dtype=torch.float32, device=device))
        if layer.use_batchnorm:
            scale, bias = layer.bn_affine()
            y = y * scale + bias
    y = y.cpu().numpy().astype(np.float64)

    out_codes = quantize_to_int(y, f_out[None], i_out[None],
                                layer.cfg_out.signed, "SAT")     # (E, ci, co)
    # pruned cells emit exactly 0 (the train/deploy boundary of the
    # reference's extract_tables: a (m <= 0, n > 0) cell is pruned here)
    live = (m > 0) & (n > 0)
    out_codes = np.where(live[None], out_codes, 0)
    return LayerTables(
        f_in=f_in, i_in=i_in, f_out=f_out, i_out=i_out,
        in_width=m.astype(np.int32), out_width=n.astype(np.int32),
        codes=np.transpose(out_codes, (1, 2, 0)).astype(np.int64),
    )
