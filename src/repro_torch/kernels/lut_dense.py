"""Kernel B2: the LUT-Dense forward, and its wrapper (the eval forward, and
the forward of the fused train pair in ``kernels/ops.lut_dense``).

Replaces the TPU kernel ``repro.kernels.lut_dense.lut_dense_fused``.  The
CUDA source is ``csrc/lut_dense.cu`` (one thread per ``(b, o)`` output, a
loop over ``C_in`` and ``H``, nothing of shape ``(B, C_in, H, C_out)``
written); its note says what bounds it on the H100.  The plain version is
:func:`repro_torch.kernels.ref.lut_dense_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_dense_ref

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lut_dense")
        lib.lut_dense_forward.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.lut_dense_forward.restype = ctypes.c_int
        lib.lut_dense_error_string.argtypes = [ctypes.c_int]
        lib.lut_dense_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def lut_dense_fused(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
    """LUT-Dense forward; shapes as :func:`ref.lut_dense_ref`.

    x (B, C_in); w0/b0/w_out (C_in, H, C_out); b_out and the integer-valued
    bit-width tensors (C_in, C_out), all float32.  CPU tensors take the plain
    version; CUDA tensors launch kernel B2.
    """
    if x.device.type == "cpu":
        return lut_dense_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)
    if x.device.type != "cuda":
        raise ValueError(f"lut_dense_fused: no kernel for device {x.device}")
    return _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)


def _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
    if x.dim() != 2:
        raise ValueError(f"x must be (B, C_in), got {tuple(x.shape)}")
    batch, c_in = x.shape
    if w0.dim() != 3 or w0.shape[0] != c_in:
        raise ValueError(f"w0 must be (C_in={c_in}, H, C_out), got {tuple(w0.shape)}")
    hidden, c_out = w0.shape[1], w0.shape[2]
    grid = (c_in, c_out)
    args = {"x": x, "w0": w0, "b0": b0, "w_out": w_out, "b_out": b_out,
            "f_in": f_in, "i_in": i_in, "f_out": f_out, "i_out": i_out}
    for name, t in args.items():
        want = (tuple(x.shape) if name == "x" else tuple(w0.shape)
                if name in ("w0", "b0", "w_out") else grid)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if batch * c_out >= 2 ** 31:
        raise ValueError(f"batch {batch} x C_out {c_out} exceeds the kernel's "
                         f"31-bit index range")
    out = torch.empty((batch, c_out), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.lut_dense_forward(
        *(t.data_ptr() for t in args.values()), out.data_ptr(),
        batch, c_in, hidden, c_out, stream)
    if rc != 0:
        raise RuntimeError(f"lut_dense_forward launch failed: "
                           f"{lib.lut_dense_error_string(rc).decode()}")
    build.LAUNCHES["lut_dense"] += 1
    return out
