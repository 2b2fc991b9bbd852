"""Frozen yardstick arithmetic: the H100's peaks, the roofline bound, the
operations and bytes of kernels B1-B4 at a cell's shapes, and the
operations a model step needs.

The bound functions are copies of ``bound``, ``b2_bound``, ``b3_bound`` and
the B1 terms of ``b1_timings`` in ``chip_smoke.py`` at commit
1e35da467a58367bd43292fb4c37d72db1ec41f5, rewritten to take shapes instead
of tensors; ``pid_chain_ops`` and ``pid_chain_bytes`` count B4's work from
the hybrid's shapes and grids with the per-term costs of that file's
``b4_bound``.  The program may change its own copies; these stay.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit):
# HBM3 bandwidth and the float32 rate outside the tensor cores.  Integer
# operations are counted against the float32 rate too: the H100's int32
# rate is lower, so a share against it can only read smaller.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least time the chip could take, in seconds, and what bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ B1
def b1_contiguous(batch: int, c_in: int, c_out: int) -> Tuple[float, str]:
    """B1 on a contiguous (batch, c_in, c_out) float32 array with per-cell
    widths: x read and y written once, both width arrays read once; ~10
    operations an element."""
    n = batch * c_in * c_out
    return bound_s(8 * n + 8 * c_in * c_out, 10 * n)


def b1_expand(batch: int, c_in: int, c_out: int) -> Tuple[float, str]:
    """B1 on the (batch, c_in) input expanded along a new c_out axis: the
    source read once, the (batch, c_in, c_out) output written once."""
    n = batch * c_in * c_out
    return bound_s(4 * n + 4 * batch * c_in + 8 * c_in * c_out, 10 * n)


# ------------------------------------------------------------------ B2, B3
def _arg_elems(c_in: int, c_out: int, hidden: int) -> Tuple[int, int]:
    """Elements of B2/B3's weight arguments (w0, b0, w_out: c_in*H*c_out
    each; b_out: c_in*c_out) and of their four width arguments."""
    return 3 * c_in * hidden * c_out + c_in * c_out, 4 * c_in * c_out


def lut_dense_fwd_ops(c_in: int, c_out: int, hidden: int) -> int:
    """Operations of one row through a LUT-Dense layer's forward: per cell
    a WRAP quantizer (~8) and a SAT quantizer (~6), per hidden unit mul,
    add, tanh (as one), mul, add."""
    return c_in * c_out * (5 * hidden + 14)


def lut_dense_bwd_ops(c_in: int, c_out: int, hidden: int) -> int:
    """Operations of one row through a LUT-Dense layer's backward:
    quantizers and surrogates ~30 a cell, ~16 a hidden unit."""
    return c_in * c_out * (16 * hidden + 30)


def b2(batch: int, c_in: int, c_out: int, hidden: int) -> Tuple[float, str]:
    w, q = _arg_elems(c_in, c_out, hidden)
    n_bytes = 4 * (batch * c_in + batch * c_out + w + q)
    return bound_s(n_bytes, batch * lut_dense_fwd_ops(c_in, c_out, hidden))


def b3(batch: int, c_in: int, c_out: int, hidden: int) -> Tuple[float, str]:
    """Its inputs read and its gradients written once (every input but the
    cotangent has a gradient of its size)."""
    w, q = _arg_elems(c_in, c_out, hidden)
    n_bytes = 4 * (2 * batch * c_in + batch * c_out + 2 * w + 2 * q)
    return bound_s(n_bytes, batch * lut_dense_bwd_ops(c_in, c_out, hidden))


def lut_stack_train_ops(dims: Sequence[int], hidden: int) -> int:
    """Operations one sample needs in a train step of a LUT-Dense stack:
    every layer's forward and backward, counted as B2 and B3 count them
    (not the work the einsum path materialises)."""
    return sum(lut_dense_fwd_ops(ci, co, hidden) + lut_dense_bwd_ops(ci, co, hidden)
               for ci, co in zip(dims[:-1], dims[1:]))


# ------------------------------------------------------------------ B4
# per-term operation costs of B4's stages (chip_smoke.b4_bound): a LUT term
# is a gather, mask, load and add (4), plus ~8 to requantize its input onto
# the cell's grid where the grids differ; a multiply-accumulate term is a
# gather, multiply and add (3); a REQUANT epilogue ~10, any other 1; one
# more an output for its bias or alignment
LUT_TERM_OPS = 4
SHIFT_OPS = 8
MAC_TERM_OPS = 3
REQUANT_OPS = 10


def pid_chain_ops(layers: Sequence[Dict]) -> int:
    """Integer operations of one row through the PID hybrid's chain.

    ``layers`` describes each stage in order: ``{"kind": "mac", "sites",
    "c_in", "c_out", "relu"}`` for the HGQ front (its inputs requantized
    once a site, a REQUANT epilogue for relu), ``{"kind": "lut", "sites",
    "c_in", "c_out", "shift"}`` for a LUT layer (``shift``: the number of
    cells whose input grid differs from their own), and ``{"kind": "sum",
    "sites", "c"}`` for the window sum."""
    ops = 0
    for st in layers:
        s = st["sites"]
        if st["kind"] == "mac":
            epi = REQUANT_OPS if st["relu"] else 1
            ops += s * (st["c_in"] * REQUANT_OPS
                        + st["c_out"] * (st["c_in"] * MAC_TERM_OPS + 1 + epi))
        elif st["kind"] == "lut":
            ops += s * (st["c_in"] * st["c_out"] * LUT_TERM_OPS
                        + st["shift"] * SHIFT_OPS + st["c_out"])
        elif st["kind"] == "sum":
            ops += s * st["c"]
        else:
            raise ValueError(f"unknown stage kind {st['kind']!r}")
    return ops


def pid_chain_bytes(batch: int, n_in: int, n_out: int, table_bytes: int,
                    code_bytes: int = 4) -> int:
    """B4's bytes on ``batch`` rows: the input and output codes (int32)
    moved once and every live table read once."""
    return code_bytes * batch * (n_in + n_out) + table_bytes


def b4(batch: int, n_in: int, n_out: int, table_bytes: int,
       ops_row: int) -> Tuple[float, str]:
    return bound_s(pid_chain_bytes(batch, n_in, n_out, table_bytes), ops_row * batch)
