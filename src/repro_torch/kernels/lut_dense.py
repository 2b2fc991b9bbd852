"""Kernel B2: the LUT-Dense forward, and its wrapper (the eval forward, and
the forward of the fused train pair in ``kernels/ops.lut_dense``).

Replaces the TPU kernel ``repro.kernels.lut_dense.lut_dense_fused``.  The
CUDA source is ``csrc/lut_dense.cu``: one launch of blocks that each own a
range of batch rows and a chunk of outputs, one warp an output for a row
of 32 at a time and one lane a row, sized by :func:`launch_plan` to fill
the card in one balanced wave; each block stages its cells' quantizer
constants, weights and x tile in shared memory once, and each lane sums its
row's cells over ``C_in`` in index order in one register, so the output is
the plain version's, bit for bit.  Its note says what bounds it on the
H100.  The plain version is :func:`repro_torch.kernels.ref.lut_dense_ref`.

:func:`lut_bn_stats_fused` launches the same file's ``lut_bn_stats_kernel``:
train-mode batch-norm's batch statistics of the cell outputs, which
``core/lut_layers.py`` folds into B2's output projection.  It splits each
input channel's batch as B3 does (``lut_dense_bwd.launch_plan``, and
scratch kept as B3 keeps its own); its plain version is
:func:`repro_torch.kernels.ref.lut_bn_stats_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, lut_dense_bwd
from repro_torch.kernels.ref import lut_bn_stats_ref, lut_dense_ref

# what csrc/lut_dense.cu stages (its static_assert and lut_dense_forward_smem
# hold the kernel to these), and what an H100 SM holds
CELL_BYTES = 64                 # sizeof(lut::Cell), csrc/lut_cell.cuh
MAX_HIDDEN = 16                 # widest instantiation; above it H is a runtime loop
MAX_WARPS = 32                  # warps of a block (1024 threads)
STAGE_BYTES = 96 * 1024         # shared memory for one chunk of cells and weights,
                                # and at most as much again for the x tile
SMEM_PER_SM = 228 * 1024        # shared memory of an SM ...
SMEM_PER_BLOCK = 1024           # ... of which the runtime reserves this per block

_BLOCKS_PER_SM: Dict[Tuple[int, int, int], int] = {}   # (device, H, warps) -> occupancy
_PLANS: Dict[tuple, "LaunchPlan"] = {}                  # (device, B, C_in, H, C_out) -> plan


class LaunchPlan(NamedTuple):
    block_rows: int    # batch rows of every block but the last, a multiple of 32
    o_chunk: int       # outputs of a block
    groups: int        # rows of 32 a block computes at once: groups x o_chunk warps
    j_chunk: int       # input channels staged in shared memory at once
    n_row_blocks: int  # the grid is n_row_blocks x n_o_chunks
    n_o_chunks: int
    smem: int          # dynamic shared memory of a block, bytes


def block_smem(rows: int, c_in: int, o_chunk: int, hidden: int) -> Tuple[int, int]:
    """``(j_chunk, smem)`` of a block of ``rows`` rows by ``o_chunk``
    outputs: the input channels it stages at once (their cells and weights
    in ``STAGE_BYTES``, its x tile of odd row stride in as much again) and
    the dynamic shared memory that takes, as ``csrc/lut_dense.cu`` lays it
    out."""
    staged_h = hidden if hidden <= MAX_HIDDEN else 0     # the generic one reads global memory
    per_j = o_chunk * (CELL_BYTES + 16 * staged_h)
    x_cap = STAGE_BYTES // (4 * rows)
    j_chunk = min(c_in, STAGE_BYTES // per_j, x_cap)
    if (j_chunk | 1) > x_cap:
        j_chunk -= 1
    j_chunk = max(1, j_chunk)
    return j_chunk, j_chunk * per_j + rows * (j_chunk | 1) * 4


def launch_plan(batch: int, c_in: int, c_out: int, hidden: int, sm_count: int,
                blocks_per_sm: Callable[[int], int]) -> LaunchPlan:
    """The grid of blocks of ``block_rows`` rows by ``o_chunk`` outputs, each
    of ``groups x o_chunk`` warps (warp (g, o) takes output o and the rows
    32 g + lane, 32 (g + groups) + lane, ...), that gives the busiest SM the
    fewest rows to compute while the grid fits the blocks the card holds at
    once: ``blocks_per_sm(warps)`` by registers and threads (the occupancy
    query), fewer where the block's shared memory (:func:`block_smem`) allows
    fewer.  Of plans that load the SMs alike, the one whose warps each loop
    over the fewest rows, then the one with the fewest blocks (each stages
    its cells and weights).  Outputs are split into near-equal chunks of at
    most ``MAX_WARPS``."""
    n_o = max(1, -(-c_out // MAX_WARPS))
    o_chunk = max(1, -(-c_out // n_o))
    row_groups = max(1, -(-batch // 32))                 # rows of 32
    best = None
    for groups in range(1, MAX_WARPS // o_chunk + 1):
        threads_occ = blocks_per_sm(groups * o_chunk)
        k = 0
        while True:                       # rows of 32 a block: a multiple of groups
            k += groups
            j_chunk, smem = block_smem(32 * k, c_in, o_chunk, hidden)
            occ = max(1, min(threads_occ, SMEM_PER_SM // (smem + SMEM_PER_BLOCK)))
            n_row = -(-row_groups // k)
            per_sm = -(-(n_row * n_o) // sm_count)       # blocks on the busiest SM
            if per_sm <= occ or n_row == 1 or 32 * (k + groups) * 8 > STAGE_BYTES:
                break
        cost = (-(-per_sm // occ), per_sm * k, k // groups, n_row * n_o)
        if best is None or cost < best[0]:
            best = cost, LaunchPlan(32 * k, o_chunk, groups, j_chunk, n_row, n_o, smem)
        if n_row == 1:                    # more groups would only idle warps
            break
    return best[1]


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut_dense_forward.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.lut_dense_forward.restype = ctypes.c_int
    lib.lut_dense_forward_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.lut_dense_forward_blocks_per_sm.restype = ctypes.c_int
    lib.lut_dense_forward_smem.argtypes = [ctypes.c_int] * 4
    lib.lut_dense_forward_smem.restype = ctypes.c_longlong
    lib.lut_dense_error_string.argtypes = [ctypes.c_int]
    lib.lut_dense_error_string.restype = ctypes.c_char_p
    lib.lut_bn_stats.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.lut_bn_stats.restype = ctypes.c_int
    lib.lut_bn_stats_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.lut_bn_stats_blocks_per_sm.restype = ctypes.c_int
    lib.lut_bn_stats_max_split_rows.argtypes = []
    lib.lut_bn_stats_max_split_rows.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.load("lut_dense", _bind)


def lut_dense_fused(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out):
    """LUT-Dense forward; shapes as :func:`ref.lut_dense_ref`.

    x (B, C_in); w0/b0/w_out (C_in, H, C_out); b_out and the integer-valued
    bit-width tensors (C_in, C_out), all float32.  CPU tensors take the plain
    version; CUDA tensors launch kernel B2, at any H >= 1.  The first call of
    a shape on a device queries the card, so make it before a CUDA graph
    capture.
    """
    if x.device.type == "cpu":
        return lut_dense_ref(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)
    if x.device.type != "cuda":
        raise ValueError(f"lut_dense_fused: no kernel for device {x.device}")
    return _launch(x, w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)


_NAMES = ("x", "w0", "b0", "w_out", "b_out", "f_in", "i_in", "f_out", "i_out")


def _check(args) -> int:
    """Raise unless the nine inputs are what the kernel reads: float32,
    contiguous, on x's device, with the shapes of ``ref.lut_dense_ref`` and
    H >= 1.  Returns x's device index (-1 on the CPU).  One test a tensor,
    the message formed only on failure: the train step is host-bound."""
    x, w0 = args[0], args[1]
    if x.dim() != 2 or w0.dim() != 3 or w0.shape[0] != x.shape[1] or w0.shape[1] < 1:
        raise ValueError(f"x must be (B, C_in) and w0 (C_in, H >= 1, C_out), got "
                         f"{tuple(x.shape)} and {tuple(w0.shape)}")
    (batch, c_in), w = x.shape, w0.shape
    cell = (c_in, w[2])
    dev, f32 = x.get_device(), torch.float32
    for name, t, shape in zip(_NAMES, args, (x.shape, w, w, w, cell, cell, cell, cell, cell)):
        if (t.shape != shape or t.dtype is not f32 or t.get_device() != dev
                or not t.is_contiguous() or (dev < 0 and t.device != x.device)):
            if t.shape != shape:
                raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
            raise ValueError(f"{name} must be contiguous float32 on {x.device}, got "
                             f"{t.dtype} on {t.device}, strides {t.stride()}")
    if batch * max(c_in, w[2]) >= 2 ** 31:
        raise ValueError(f"batch {batch} exceeds the kernel's 31-bit index range")
    return dev


def _plan(lib, device: int, batch, c_in, hidden, c_out) -> LaunchPlan:
    """The launch plan of a call shape on device index ``device``, queried
    and computed once, its shared memory held to the kernel's own count."""
    key = (device, batch, c_in, hidden, c_out)
    plan = _PLANS.get(key)
    if plan is None:
        def occupancy(warps: int) -> int:
            occ = _BLOCKS_PER_SM.get((device, hidden, warps))
            if occ is None:
                with torch.cuda.device(device):
                    occ = max(1, lib.lut_dense_forward_blocks_per_sm(hidden, warps))
                _BLOCKS_PER_SM[(device, hidden, warps)] = occ
            return occ

        sms = torch.cuda.get_device_properties(device).multi_processor_count
        plan = launch_plan(batch, c_in, c_out, hidden, sms, occupancy)
        smem = lib.lut_dense_forward_smem(plan.block_rows, plan.j_chunk, plan.o_chunk,
                                          hidden)
        if smem != plan.smem:
            raise RuntimeError(f"lut_dense: the planner counts {plan.smem} bytes of "
                               f"shared memory a block, the kernel {smem}: block_smem "
                               f"and csrc/lut_dense.cu disagree")
        _PLANS[key] = plan
    return plan


def _launch(*args):
    dev = _check(args)
    x, w0 = args[0], args[1]
    batch, c_in = x.shape
    _, hidden, c_out = w0.shape
    out = x.new_empty((batch, c_out))
    if not c_in:                            # an empty sum: zeros, as the plain version
        return out.zero_()
    if batch and c_out:
        lib = _lib()
        plan = _plan(lib, dev, batch, c_in, hidden, c_out)
        rc = lib.lut_dense_forward(
            *(t.data_ptr() for t in args), out.data_ptr(), batch, c_in, hidden,
            c_out, plan.block_rows, plan.j_chunk, plan.o_chunk, plan.groups,
            torch._C._cuda_getCurrentRawStream(dev))     # the current stream, as a pointer
        if rc != 0:
            raise RuntimeError(f"lut_dense_forward launch failed: "
                               f"{lib.lut_dense_error_string(rc).decode()}")
        build.count_launch("lut_dense")
    return out


def lut_bn_stats_fused(x, w0, b0, w_out, b_out, f_in, i_in):
    """Each cell's mean and population variance over the batch of its raw
    output (before the output quantizer), ``(mean, var)`` of shape (C_in,
    C_out); inputs as :func:`lut_dense_fused` without the output widths.
    CPU tensors take the plain version; CUDA tensors launch
    ``lut_bn_stats_kernel``, at any H >= 1 and B >= 1.  The first call of a
    shape on a device queries the card and may allocate scratch, so make it
    before a CUDA graph capture."""
    if x.device.type == "cpu":
        return lut_bn_stats_ref(x, w0, b0, w_out, b_out, f_in, i_in)
    if x.device.type != "cuda":
        raise ValueError(f"lut_bn_stats_fused: no kernel for device {x.device}")
    args = (x, w0, b0, w_out, b_out, f_in, i_in)
    dev = _check(args)
    (batch, c_in), (_, hidden, c_out) = x.shape, w0.shape
    if batch < 1:
        raise ValueError("lut_bn_stats_fused: the statistics of an empty batch")
    mean, var = x.new_empty((c_in, c_out)), x.new_empty((c_in, c_out))
    if c_out:
        lib = _lib()
        plan = lut_dense_bwd.plan_for("lut_bn_stats", x.device, (batch, c_in, hidden, c_out),
                                      lambda: (lib.lut_bn_stats_blocks_per_sm(hidden),
                                               lib.lut_bn_stats_max_split_rows()), 2)
        tickets, partial = lut_dense_bwd.workspace("lut_bn_stats", x.device, plan)
        rc = lib.lut_bn_stats(
            *(t.data_ptr() for t in args), mean.data_ptr(), var.data_ptr(),
            partial, tickets, batch, c_in, hidden, c_out, plan.n_split, plan.split_rows,
            torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            raise RuntimeError(f"lut_bn_stats launch failed: "
                               f"{lib.lut_dense_error_string(rc).decode()}")
        build.count_launch("lut_bn_stats")
    return mean, var
