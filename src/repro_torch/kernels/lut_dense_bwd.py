"""Kernel B3: the recompute backward of the LUT-Dense forward, and its wrapper.

Replaces the TPU kernel ``repro.kernels.lut_dense_bwd.lut_dense_bwd_fused``.
The CUDA source is ``csrc/lut_dense_bwd.cu``: a pass over (batch tile, j)
blocks that recomputes the forward in registers and writes one partial sum
per (tile, cell), then a second pass that sums the partials in tile order,
so the gradients are the same bits from run to run; its note says what
bounds it on the H100.  The plain version is
:func:`repro_torch.kernels.ref.lut_dense_bwd_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_dense_bwd_ref

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lut_dense_bwd")
        lib.lut_dense_backward.argtypes = [ctypes.c_void_p] * 19 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lut_dense_backward.restype = ctypes.c_int
        for fn in (lib.lut_dense_backward_tile_rows,
                   lib.lut_dense_backward_max_hidden):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.lut_dense_backward_error_string.argtypes = [ctypes.c_int]
        lib.lut_dense_backward_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def lut_dense_bwd_fused(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g):
    """Train-mode LUT-Dense backward; shapes as ``ref.lut_dense_bwd_ref``.

    Returns ``(dx, dw0, db0, dw_out, db_out, df_in, df_out, di_out)``;
    ``di_in`` is identically zero under WRAP and left to the caller.  CPU
    tensors take the plain version; CUDA tensors launch kernel B3.
    """
    if x.device.type == "cpu":
        return lut_dense_bwd_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out,
                                 i_out, g)
    if x.device.type != "cuda":
        raise ValueError(f"lut_dense_bwd_fused: no kernel for device {x.device}")
    return _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g)


def _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, C_in), got {tuple(x.shape)}")
    batch, c_in = x.shape
    if w0.dim() != 3 or w0.shape[0] != c_in:
        raise ValueError(f"w0 must be (C_in={c_in}, H, C_out), got {tuple(w0.shape)}")
    hidden, c_out = w0.shape[1], w0.shape[2]
    lib = _lib()
    if hidden > lib.lut_dense_backward_max_hidden():
        raise ValueError(f"hidden {hidden} exceeds the kernel's maximum "
                         f"{lib.lut_dense_backward_max_hidden()}")
    grid = (c_in, c_out)
    args = {"x": x, "w0": w0, "b0": b0, "w_out": w_out, "b_out": b_out,
            "f_in": f_in, "i_in": i_in, "f_out": f_out, "i_out": i_out, "g": g}
    for name, t in args.items():
        want = ((batch, c_in) if name == "x" else (batch, c_out) if name == "g"
                else tuple(w0.shape) if name in ("w0", "b0", "w_out") else grid)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if batch * max(c_in, c_out) >= 2 ** 31:
        raise ValueError(f"batch {batch} exceeds the kernel's 31-bit index range")
    tile = lib.lut_dense_backward_tile_rows()
    n_tiles = -(-batch // tile)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((batch, c_in), **f32)
    dw0, db0, dwo = (torch.empty(tuple(w0.shape), **f32) for _ in range(3))
    dbo, dfi, dfo, dio = (torch.empty(grid, **f32) for _ in range(4))
    partial = torch.empty((max(n_tiles, 1), c_in, 3 * hidden + 4, c_out), **f32)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    outs = (dx, dw0, db0, dwo, dbo, dfi, dfo, dio, partial)
    rc = lib.lut_dense_backward(
        *(t.data_ptr() for t in args.values()), *(t.data_ptr() for t in outs),
        batch, c_in, hidden, c_out, stream)
    if rc != 0:
        raise RuntimeError(f"lut_dense_backward launch failed: "
                           f"{lib.lut_dense_backward_error_string(rc).decode()}")
    build.LAUNCHES["lut_dense_bwd"] += 1
    return dx, dw0, db0, dwo, dbo, dfi, dfo, dio
