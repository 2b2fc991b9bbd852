"""Kernel B3: the recompute backward of the LUT-Dense forward, and its wrapper.

Replaces the TPU kernel ``repro.kernels.lut_dense_bwd.lut_dense_bwd_fused``.
The CUDA source is ``csrc/lut_dense_bwd.cu``: one launch of ``n_split x
C_in`` blocks, sized by :func:`launch_plan` to fill the card in one wave,
each recomputing the forward for one input channel over a range of batch
rows and writing one partial sum per gradient element; the last block of a
channel sums its partials in split order, so the gradients are the same bits
from run to run.  Its note says what bounds it on the H100.  The plain
version is :func:`repro_torch.kernels.ref.lut_dense_bwd_ref`.

:func:`lut_bn_stats_grad_fused` is the same kernel in its batch-norm mode
(``lut_bn_stats_grad_kernel``): the backward of the batch statistics of
``kernels/lut_dense.py::lut_bn_stats_fused``, on the same grid and scratch
scheme; its plain version is :func:`repro_torch.kernels.ref.
lut_bn_stats_grad_ref`.  :func:`launch_plan` and :func:`workspace` plan and
hold the scratch of all three kernels that split a channel's batch so.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_bn_stats_grad_ref, lut_dense_bwd_ref

# a split holds at least a warp of rows, when the batch allows
MIN_SPLIT_ROWS = 32

_BLOCKS_PER_SM: Dict[tuple, tuple] = {}           # (kernel, device, hidden) -> (occupancy,
                                                   # most rows a split)
_PLANS: Dict[tuple, "LaunchPlan"] = {}             # (kernel, device, B, C_in, H, C_out) -> plan
_WORKSPACE: Dict[tuple, tuple] = {}                # (kernel, device) -> (tickets, partials)
# every scratch pair a larger one replaced: a captured CUDA graph keeps the
# pointers it was captured with, so no scratch is ever freed
_RETIRED: List[tuple] = []


class LaunchPlan(NamedTuple):
    n_split: int       # row ranges per input channel; the grid is n_split x C_in
    split_rows: int    # rows of every range but the last, which may be shorter
    n_partial: int     # floats of partial sums: n_split x C_in x n_sums x C_out
    n_tickets: int     # zeroed counters the kernel needs: one per input channel


def launch_plan(batch: int, c_in: int, c_out: int, hidden: int, sm_count: int,
                blocks_per_sm: int, max_split_rows: int = 2048,
                n_sums: Optional[int] = None) -> LaunchPlan:
    """Split each input channel's batch into row ranges so that the ``n_split
    x c_in`` blocks fill the ``sm_count x blocks_per_sm`` the card holds at
    once, with at least ``MIN_SPLIT_ROWS`` rows a range where the batch
    allows, at most ``max_split_rows`` (the kernel's shared memory or
    registers), and none empty.  A range keeps ``n_sums`` partial sums a
    cell (B3's 3H + 4 by default)."""
    if n_sums is None:
        n_sums = 3 * hidden + 4
    n_split = max(1, sm_count * blocks_per_sm // max(c_in, 1))
    n_split = min(n_split, max(1, -(-batch // MIN_SPLIT_ROWS)))
    n_split = max(n_split, -(-batch // max_split_rows))
    split_rows = -(-batch // n_split)
    if batch:
        n_split = -(-batch // split_rows)
    return LaunchPlan(n_split, split_rows, n_split * c_in * n_sums * c_out, c_in)


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut_dense_backward.argtypes = [ctypes.c_void_p] * 20 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lut_dense_backward.restype = ctypes.c_int
    lib.lut_dense_backward_max_split_rows.argtypes = []
    lib.lut_dense_backward_max_split_rows.restype = ctypes.c_int
    lib.lut_dense_backward_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.lut_dense_backward_blocks_per_sm.restype = ctypes.c_int
    lib.lut_dense_backward_error_string.argtypes = [ctypes.c_int]
    lib.lut_dense_backward_error_string.restype = ctypes.c_char_p
    lib.lut_bn_stats_backward.argtypes = [ctypes.c_void_p] * 18 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.lut_bn_stats_backward.restype = ctypes.c_int
    lib.lut_bn_stats_backward_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.lut_bn_stats_backward_blocks_per_sm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.load("lut_dense_bwd", _bind)


def lut_dense_bwd_fused(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g):
    """Train-mode LUT-Dense backward; shapes as ``ref.lut_dense_bwd_ref``.

    Returns ``(dx, dw0, db0, dw_out, db_out, df_in, df_out, di_out)``;
    ``di_in`` is identically zero under WRAP and left to the caller.  CPU
    tensors take the plain version; CUDA tensors launch kernel B3, at any
    H >= 1 (H > 16 on its generic instantiation).  The
    kernel's scratch (its tickets and partial sums) is kept per device, so
    calls on one device run one after another (one stream, or streams that
    wait on each other); the first call of a shape on a device queries the
    card and may allocate scratch, so make it before a CUDA graph capture.
    """
    if x.device.type == "cpu":
        return lut_dense_bwd_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out,
                                 i_out, g)
    if x.device.type != "cuda":
        raise ValueError(f"lut_dense_bwd_fused: no kernel for device {x.device}")
    return _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out, g)


_NAMES = ("x", "w0", "b0", "w_out", "b_out", "f_in", "i_in", "f_out", "i_out", "g")


_BN_NAMES = ("x", "w0", "b0", "w_out", "b_out", "f_in", "i_in", "mean", "g_mean", "g_var")


def _check(args, names=_NAMES) -> None:
    """Raise unless the ten inputs are what the kernel reads: float32,
    contiguous, on x's device, with the shapes of ``ref.lut_dense_bwd_ref``
    (``names`` B3's) or of ``ref.lut_bn_stats_grad_ref`` (``_BN_NAMES``,
    every input after the weights cell-shaped)."""
    x, w0 = args[0], args[1]
    if x.dim() != 2 or w0.dim() != 3 or w0.shape[1] < 1:
        raise ValueError(f"x must be (B, C_in) and w0 (C_in, H >= 1, C_out), got "
                         f"{tuple(x.shape)} and {tuple(w0.shape)}")
    (batch, c_in), (_, hidden, c_out) = x.shape, w0.shape
    cell, w = (c_in, c_out), (c_in, hidden, c_out)
    want = ((batch, c_in), w, w, w, cell, cell, cell, cell, cell,
            cell if names is _BN_NAMES else (batch, c_out))
    dev = x.device
    for name, t, shape in zip(names, args, want):
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {dev}, got "
                             f"{t.dtype} on {t.device}, strides {t.stride()}")
    if batch * max(c_in, c_out) >= 2 ** 31:
        raise ValueError(f"batch {batch} exceeds the kernel's 31-bit index range")


def plan_for(kernel: str, device, shape, query: Callable[[], Tuple[int, int]],
             n_sums: int) -> LaunchPlan:
    """The launch plan of ``kernel`` at ``shape`` = (B, C_in, H, C_out) on
    ``device``, computed once, with ``n_sums`` partial sums a cell;
    ``query()`` gives the occupancy of its instantiation for H and its most
    rows a split, and is called on the first plan of an H."""
    batch, c_in, hidden, c_out = shape
    key = (kernel, device.index, *shape)
    plan = _PLANS.get(key)
    if plan is None:
        limits = _BLOCKS_PER_SM.get((kernel, device.index, hidden))
        if limits is None:
            with torch.cuda.device(device):
                occ, max_rows = query()
            limits = _BLOCKS_PER_SM[(kernel, device.index, hidden)] = (max(1, occ), max_rows)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(batch, c_in, c_out, hidden, sms, *limits, n_sums)
        _PLANS[key] = plan
    return plan


def _plan(lib, device, batch, c_in, hidden, c_out) -> LaunchPlan:
    return plan_for("lut_dense_bwd", device, (batch, c_in, hidden, c_out),
                    lambda: (lib.lut_dense_backward_blocks_per_sm(hidden),
                             lib.lut_dense_backward_max_split_rows()), 3 * hidden + 4)


def workspace(kernel: str, device, plan: LaunchPlan) -> Tuple[int, int]:
    """Pointers to ``kernel``'s scratch on ``device``: the zeroed tickets
    (which the kernel leaves zeroed) and room for the partial sums, grown
    as a call needs, kept across calls.  A scratch that is outgrown stays
    allocated (``_RETIRED``): a CUDA graph that captured a launch goes on
    using it in every replay."""
    ws = _WORKSPACE.get((kernel, device.index))
    if ws is None or ws[0].numel() < plan.n_tickets or ws[1].numel() < plan.n_partial:
        if ws is not None:
            _RETIRED.append(ws)
        n_t = max(plan.n_tickets, 64, ws[0].numel() if ws else 0)
        n_p = max(plan.n_partial, ws[1].numel() if ws else 0)
        ws = (torch.zeros(n_t, dtype=torch.int32, device=device),
              torch.empty(n_p, dtype=torch.float32, device=device))
        _WORKSPACE[(kernel, device.index)] = ws
    return ws[0].data_ptr(), ws[1].data_ptr()


def _launch(*args):
    _check(args)
    x, w0 = args[0], args[1]
    batch, c_in = x.shape
    hidden, c_out = w0.shape[1], w0.shape[2]
    f32 = dict(dtype=torch.float32, device=x.device)
    # three allocations, the weight and cell gradients each split off one
    # (cheaper on the host than views of a single buffer)
    dx = torch.empty((batch, c_in), **f32)
    w3 = torch.empty((3, c_in, hidden, c_out), **f32)
    c4 = torch.empty((4, c_in, c_out), **f32)
    if c_in and c_out:
        lib = _lib()
        plan = _plan(lib, x.device, batch, c_in, hidden, c_out)
        tickets, partial = workspace("lut_dense_bwd", x.device, plan)
        w_ptr, c_ptr = w3.data_ptr(), c4.data_ptr()
        nw, nc = 4 * c_in * hidden * c_out, 4 * c_in * c_out      # bytes of one gradient
        rc = lib.lut_dense_backward(
            *(t.data_ptr() for t in args), dx.data_ptr(), w_ptr, w_ptr + nw,
            w_ptr + 2 * nw, c_ptr, c_ptr + nc, c_ptr + 2 * nc, c_ptr + 3 * nc, partial,
            tickets, batch, c_in, hidden, c_out, plan.n_split, plan.split_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lut_dense_backward launch failed: "
                               f"{lib.lut_dense_backward_error_string(rc).decode()}")
        build.count_launch("lut_dense_bwd")
    else:                                   # nothing to sum: zero gradients
        for t in (dx, w3, c4):
            t.zero_()
    return (dx, *w3.unbind(0), *c4.unbind(0))


# ------------------------------------------------ batch statistics' backward
def lut_bn_stats_grad_fused(x, w0, b0, w_out, b_out, f_in, i_in, mean, g_mean, g_var):
    """The backward of ``lut_dense.lut_bn_stats_fused`` to the cotangents
    ``(g_mean, g_var)`` of its ``(mean, var)``; shapes as
    ``ref.lut_bn_stats_grad_ref``.  Returns ``(dx, dw0, db0, dw_out, db_out,
    df_in)``; ``di_in`` is identically zero under WRAP and left to the
    caller.  CPU tensors take the plain version; CUDA tensors launch
    ``lut_bn_stats_grad_kernel``, at any H >= 1, with scratch kept as B3
    keeps its own (make the first call of a shape before a capture)."""
    if x.device.type == "cpu":
        return lut_bn_stats_grad_ref(x, w0, b0, w_out, b_out, f_in, i_in, mean, g_mean,
                                     g_var)
    if x.device.type != "cuda":
        raise ValueError(f"lut_bn_stats_grad_fused: no kernel for device {x.device}")
    args = (x, w0, b0, w_out, b_out, f_in, i_in, mean, g_mean, g_var)
    _check(args, _BN_NAMES)
    batch, (c_in, hidden, c_out) = x.shape[0], w0.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((batch, c_in), **f32)
    w3 = torch.empty((3, c_in, hidden, c_out), **f32)
    c2 = torch.empty((2, c_in, c_out), **f32)
    if c_in and c_out and batch:
        lib = _lib()
        plan = plan_for("lut_bn_stats_grad", x.device, (batch, c_in, hidden, c_out),
                        lambda: (lib.lut_bn_stats_backward_blocks_per_sm(hidden),
                                 lib.lut_dense_backward_max_split_rows()), 3 * hidden + 2)
        tickets, partial = workspace("lut_bn_stats_grad", x.device, plan)
        w_ptr, c_ptr = w3.data_ptr(), c2.data_ptr()
        nw, nc = 4 * c_in * hidden * c_out, 4 * c_in * c_out      # bytes of one gradient
        rc = lib.lut_bn_stats_backward(
            *(t.data_ptr() for t in args), dx.data_ptr(), w_ptr, w_ptr + nw,
            w_ptr + 2 * nw, c_ptr, c_ptr + nc, partial, tickets, batch, c_in, hidden,
            c_out, plan.n_split, plan.split_rows,
            torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lut_bn_stats_backward launch failed: "
                               f"{lib.lut_dense_backward_error_string(rc).decode()}")
        build.count_launch("lut_bn_stats_grad")
    else:                                   # nothing to sum: zero gradients
        for t in (dx, w3, c2):
            t.zero_()
    return (dx, *w3.unbind(0), *c2.unbind(0))
