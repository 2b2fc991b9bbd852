"""Kernel B1: element-wise HGQ fake-quant, and its wrapper.

Replaces the TPU kernel ``repro.kernels.fake_quant.fake_quant_fused``.  The
CUDA source is ``csrc/fake_quant.cu`` (one grid-stride pass over ``x`` with
16-byte loads, the grid arithmetic of ``csrc/fq.cuh``); its note says what
bounds it on the H100.  The plain version is
:func:`repro_torch.kernels.ref.fake_quant_ref`.

The widths take one of three forms, none broadcast to ``x``'s size: a
scalar (per-tensor), a vector of ``x``'s last axis (per-channel), or an
array of shape ``x.shape[-r:]`` (trailing broadcast, e.g. per-cell widths
over a batch).  Leading size-1 axes of the widths are ignored; any other
shape raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fake_quant_ref

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("fake_quant")
        lib.fake_quant_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.fake_quant_forward.restype = ctypes.c_int
        lib.fake_quant_error_string.argtypes = [ctypes.c_int]
        lib.fake_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fake_quant_fused(x: torch.Tensor, f, i, *, signed: bool = True,
                     overflow: str = "SAT") -> torch.Tensor:
    """Quantize ``x`` with integer-valued bit-width tensors ``f``/``i``.

    CPU tensors take the plain version; CUDA tensors launch kernel B1 (x
    float32 and contiguous; widths float32 on x's device, integer-valued).
    """
    if overflow not in ("SAT", "WRAP"):
        raise ValueError(f"unknown overflow mode {overflow!r}")
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    i = torch.as_tensor(i, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return fake_quant_ref(x, f, i, signed, overflow)
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant_fused: no kernel for device {x.device}")
    return _launch(x, f, i, signed, overflow)


def width_period(x_shape, w_shape) -> int:
    """How often the widths repeat along flattened ``x``: 1 for one scalar
    pair, ``numel`` for widths of shape ``x.shape[-r:]``; raises otherwise."""
    w_shape = tuple(w_shape)
    while w_shape and w_shape[0] == 1:
        w_shape = w_shape[1:]
    x_shape = tuple(x_shape)
    if not w_shape:
        return 1
    if len(w_shape) <= len(x_shape) and x_shape[len(x_shape) - len(w_shape):] == w_shape:
        n = 1
        for d in w_shape:
            n *= d
        return n
    raise ValueError(f"widths of shape {w_shape} are neither a scalar nor the "
                     f"trailing shape of x {x_shape}")


def _launch(x, f, i, signed, overflow):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (not contiguous)'}")
    if f.device != x.device or i.device != x.device:
        raise ValueError(f"widths must be on {x.device}")
    fb, ib = torch.broadcast_tensors(f, i)
    period = width_period(x.shape, fb.shape)
    fb, ib = fb.contiguous(), ib.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fake_quant_forward(x.data_ptr(), fb.data_ptr(), ib.data_ptr(),
                                out.data_ptr(), x.numel(), period, int(signed),
                                int(overflow == "WRAP"), stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_forward launch failed: "
                           f"{lib.fake_quant_error_string(rc).decode()}")
    build.LAUNCHES["fake_quant"] += 1
    return out
