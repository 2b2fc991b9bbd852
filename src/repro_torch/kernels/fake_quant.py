"""Kernel B1: element-wise HGQ fake-quant, and its wrapper.

Replaces the TPU kernel ``repro.kernels.fake_quant.fake_quant_fused``.  The
CUDA source is ``csrc/fake_quant.cu`` (per-width constants held in registers
by threads that each own one float4 column of the widths' period, with
``csrc/fq.cuh``'s grid arithmetic as the fallback); its note says what
bounds it on the H100 and why its shortcuts give the same bits.  The plain
version is :func:`repro_torch.kernels.ref.fake_quant_ref`.

``x`` may be contiguous, or a view whose last axis has stride 0 over a
contiguous array (``src[..., None].expand(..., C)``, as ``LUTDense`` builds
it): the kernel then reads each source element once, with no copy in front
of it.  :func:`x_layout` tells the two apart; any other layout raises here
and is made contiguous by the caller.

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
            ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.fake_quant_forward.restype = ctypes.c_int
        lib.fake_quant_error_string.argtypes = [ctypes.c_int]
        lib.fake_quant_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fake_quant_fused(x: torch.Tensor, f, i, *, signed: bool = True,
                     overflow: str = "SAT") -> torch.Tensor:
    """Quantize ``x`` with integer-valued bit-width tensors ``f``/``i``.

    CPU tensors take the plain version; CUDA tensors launch kernel B1 (x
    float32 in a layout :func:`x_layout` takes; widths float32 on x's
    device, integer-valued).  The output is contiguous.
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


def x_layout(x: torch.Tensor):
    """``(source, expand)`` when kernel B1 reads ``x`` in place, else None.

    A contiguous ``x`` is its own source (``expand`` 1).  An ``x`` whose
    last axis has stride 0 and whose other axes are contiguous reads
    ``source[k // expand]`` for element ``k`` of the contiguous output, with
    ``source = x[..., 0]`` and ``expand = x.shape[-1]``.
    """
    if x.is_contiguous():
        return x, 1
    if x.dim() >= 1 and x.stride(-1) == 0:
        src = x[..., 0]
        if src.is_contiguous():
            return src, x.shape[-1]
    return None


def _launch(x, f, i, signed, overflow):
    layout = x_layout(x)
    if x.dtype != torch.float32 or layout is None:
        raise ValueError(f"x must be float32, contiguous or expanded along its "
                         f"last axis; got {x.dtype} with strides {x.stride()}")
    if f.device != x.device or i.device != x.device:
        raise ValueError(f"widths must be on {x.device}")
    fb, ib = torch.broadcast_tensors(f, i)
    period = width_period(x.shape, fb.shape)
    fb, ib = fb.contiguous(), ib.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out
    src, expand = layout
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.fake_quant_forward(src.data_ptr(), fb.data_ptr(), ib.data_ptr(),
                                out.data_ptr(), x.numel(), period, expand,
                                int(signed), int(overflow == "WRAP"), stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_forward launch failed: "
                           f"{lib.fake_quant_error_string(rc).decode()}")
    build.LAUNCHES["fake_quant"] += 1
    return out
