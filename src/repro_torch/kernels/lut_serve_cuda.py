"""Kernel B4: the whole packed stage chain in ONE launch, and its wrapper.

Replaces the TPU kernel ``repro.kernels.lut_serve_pallas.pallas_runner``.
The CUDA source is ``csrc/lut_serve.cu``; its note says what bounds it on
the H100 and how the block, shared-memory and thread layout follow.

Packing (:func:`pack_stages` → :class:`PackedStages`) is the reference's,
array for array, so both packages pack — and degrade — on the same models:
out-shift folding into the table entries, int8/int16/int32 lane packing
(sign-extended on read), range-driven lane narrowing from the ``live``
masks, in-shift elision, ``sign << shift`` sum coefficients, and the
residency budget that raises :exc:`PackError`.

:class:`PackedChain` then lowers the packed stages once, at engine build
time, to what the kernel interprets: one flat int64 stage-descriptor array,
one constants buffer in the compute dtype and one table buffer per lane
dtype.  :func:`run_chain` is the wrapper: CPU tensors take the plain
version :func:`run_chain_plain` (the stage loop in PyTorch over the same
packed stages), CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_serve import (EpiOp, FusedStages, _requant_cols,
                                           _shift_round)

# Packed tables + stage constants may hold at most this many bytes.  Kept
# equal to the reference's VMEM budget so both packages pack and degrade on
# the same models.  On the H100 it is an L2 bound, not a shared-memory one:
# the kernel reads tables through the 50 MB L2, and 8 MB stays resident
# there beside the streaming batch.
DEF_VMEM_BUDGET = 8 << 20

# shared memory one block can use on the H100 (227 KB)
SMEM_PER_BLOCK = 232448
# batch rows per block, shrunk when a tile's two stage buffers would not fit
DEF_TILE_ROWS = 128

_LANES = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32),
          np.dtype(np.int64))
# descriptor fields, in the order of enum Field in csrc/lut_serve.cu
(F_KIND, F_S, F_J, F_CO, F_NCOLS, F_E, F_GATHER, F_BIAS, F_INSHIFT, F_MASK,
 F_COEF, F_LANE, F_TOFF, F_NEPI, F_EPI0) = range(15)
MAX_EPI = 4
N_FIELDS = F_EPI0 + 3 * MAX_EPI


class PackError(Exception):
    """The stage chain cannot be packed; message is the fallback reason."""


@dataclasses.dataclass
class PackedStage:
    """One stage of the chain, constants pre-folded and lane-packed.

    Mirrors :class:`~repro_torch.kernels.lut_serve.FusedStage` with the run
    time work moved to pack time: ``table`` holds the out-shift-folded
    entries in the narrowest signed lane dtype, ``in_shift`` is ``None``
    when the whole stage needs no input requant, and a "sum" stage carries
    the single ``coef`` multiplier instead of (signs, shifts).
    """

    kind: str                    # "lut" | "sum"
    gather: np.ndarray           # (S, J) int64; == n_cols -> zero column
    n_cols: int                  # incoming flat width
    bias: np.ndarray             # (S, co)
    epilogue: List[EpiOp]
    # kind "lut"
    in_shift: Optional[np.ndarray] = None  # (J, co); None == all zero
    mask: Optional[np.ndarray] = None      # (J, co)
    table: Optional[np.ndarray] = None     # (J, co, E), lane dtype
    # kind "sum"
    coef: Optional[np.ndarray] = None      # (S, J) = sign << shift

    @property
    def n_sites(self) -> int:
        return self.gather.shape[0]

    @property
    def c_out(self) -> int:
        return self.bias.shape[1]


@dataclasses.dataclass
class PackedStages:
    """The packed lowering of a :class:`FusedStages` chain (plain data)."""

    stages: List[PackedStage]
    out_cols: np.ndarray         # (n_outputs,) columns of the final stage
    n_cols0: int                 # input width of the first stage

    def n_stages(self) -> int:
        return len(self.stages)

    def table_bytes(self) -> int:
        """Bytes of packed (lane-dtype, out-shift-folded) tables."""
        return int(sum(st.table.nbytes for st in self.stages
                       if st.table is not None))

    def resident_bytes(self) -> int:
        """Tables + stage constants, the residency budget's measure."""
        total = 0
        for st in self.stages:
            for a in (st.table, st.mask, st.in_shift, st.bias, st.coef,
                      st.gather):
                if a is not None:
                    total += a.nbytes
            total += sum(np.asarray(e.params).nbytes for e in st.epilogue)
        return total


def _engine_np(dtype: Optional[torch.dtype]):
    return np.int32 if dtype == torch.int32 else np.int64


def _lane_dtype(a: np.ndarray, ed) -> np.dtype:
    """Narrowest signed integer dtype holding every value of ``a``, bounded
    above by the engine dtype ``ed``."""
    if a.size == 0:
        return np.dtype(np.int8)
    lo, hi = int(a.min()), int(a.max())
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if lo >= info.min and hi <= info.max \
                and np.dtype(dt).itemsize <= np.dtype(ed).itemsize:
            return np.dtype(dt)
    return np.dtype(ed)


def pack_stages(stages: FusedStages, dtype: Optional[torch.dtype] = None, *,
                vmem_budget: int = DEF_VMEM_BUDGET) -> PackedStages:
    """Lower composed stages to the packed chain layout.

    ``dtype`` is the engine compute dtype (int32/int64); ``None`` packs with
    int64 arithmetic.  Raises :exc:`PackError` when the chain cannot be
    packed faithfully or busts the residency budget.
    """
    ed = _engine_np(dtype)
    packed: List[PackedStage] = []
    for st in stages.stages:
        bias = np.asarray(st.bias, np.int64).astype(ed)
        epis = [EpiOp(op=e.op, mode=e.mode,
                      params=np.asarray(e.params, np.int64))
                for e in st.epilogue]
        if st.kind == "lut":
            out_shift = np.asarray(st.out_shift, np.int64)
            if (out_shift < 0).any():
                raise PackError("negative out_shift cannot fold into a table")
            # fold the per-cell alignment shift into the entries, in engine
            # arithmetic so any wrap matches the fused runtime bit-for-bit
            shifted = np.asarray(st.table, np.int64).astype(ed) \
                << out_shift.astype(ed)[:, :, None]
            live = st.live
            if live is not None:
                live = np.asarray(live, bool)
                if live.shape != shifted.shape:
                    raise PackError(
                        f"live mask shape {live.shape} != table "
                        f"shape {shifted.shape}")
                # proven-dead entries can hold anything without changing
                # any in-contract result; zero is the narrowest choice
                shifted = np.where(live, shifted, 0)
                reach = np.flatnonzero(live.any(axis=(0, 1)))
                e_live = int(reach[-1]) + 1 if reach.size else 1
                if e_live < shifted.shape[2]:
                    shifted = shifted[:, :, :e_live]
            in_shift = np.asarray(st.in_shift, np.int64)
            packed.append(PackedStage(
                kind="lut", gather=np.asarray(st.gather, np.int64),
                n_cols=st.n_cols, bias=bias, epilogue=epis,
                in_shift=None if not in_shift.any() else in_shift,
                mask=np.asarray(st.mask, np.int64),
                table=shifted.astype(_lane_dtype(shifted, ed))))
        elif st.kind == "sum":
            shifts = np.asarray(st.shifts, np.int64)
            if (shifts < 0).any():
                raise PackError("negative alignment shift in a sum stage")
            coef = np.asarray(st.signs, np.int64).astype(ed) \
                << shifts.astype(ed)
            packed.append(PackedStage(
                kind="sum", gather=np.asarray(st.gather, np.int64),
                n_cols=st.n_cols, bias=bias, epilogue=epis, coef=coef))
        else:
            raise PackError(f"unknown stage kind {st.kind!r}")
    out = PackedStages(stages=packed,
                       out_cols=np.asarray(stages.out_cols, np.int64),
                       n_cols0=packed[0].n_cols if packed else 0)
    resident = out.resident_bytes()
    if resident > vmem_budget:
        raise PackError(
            f"packed tables + constants need {resident} bytes resident "
            f"(> vmem_budget={vmem_budget}); the chain cannot stay "
            f"table-resident in one launch")
    return out


# --------------------------------------------------------------------------- #
# the chain on a device: constants for the plain version and the kernel
# --------------------------------------------------------------------------- #
class PackedChain:
    """A :class:`PackedStages` chain lowered once onto ``device``.

    Holds the per-stage tensors the plain version reads and, on a CUDA
    device, the descriptor, constants and lane-table buffers kernel B4
    interprets.  Raises :exc:`PackError` when a chain cannot run as one
    launch (more than :data:`MAX_EPI` epilogue ops in a stage, or a tile row
    wider than a block's shared memory).
    """

    def __init__(self, packed: PackedStages, dtype: torch.dtype, device):
        if dtype not in (torch.int32, torch.int64):
            raise ValueError(f"chain dtype must be int32 or int64, got {dtype}")
        self.packed, self.dtype = packed, dtype
        self.device = torch.device(device)
        self.n_in, self.n_out = packed.n_cols0, len(packed.out_cols)
        self._plain = [self._plain_stage(st) for st in packed.stages]
        self._out_cols = torch.as_tensor(packed.out_cols, device=self.device)
        widths = [packed.n_cols0] + [st.n_sites * st.c_out for st in packed.stages]
        for k, st in enumerate(packed.stages):
            if st.n_cols != widths[k]:
                raise PackError(f"stage {k} reads {st.n_cols} columns but its "
                                f"input has {widths[k]}")
        self.width = max(widths)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.tile_rows = min(DEF_TILE_ROWS,
                             SMEM_PER_BLOCK // (2 * self.width * itemsize))
        if self.tile_rows < 1:
            raise PackError(f"a {self.width}-wide stage row does not fit one "
                            f"block's shared memory twice")
        if self.device.type == "cuda":
            self._upload(*self._descriptors())

    # ------------------------------------------------------------ plain
    def _plain_stage(self, st: PackedStage) -> Dict[str, torch.Tensor]:
        dev, dt = self.device, self.dtype

        def c(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev).to(dt)

        t = {"gather": torch.as_tensor(st.gather, device=dev),
             "bias": c(st.bias), "epi": [c(e.params) for e in st.epilogue]}
        if st.kind == "lut":
            t["in_shift"] = None if st.in_shift is None else c(st.in_shift)
            t["mask"] = c(st.mask)
            t["table"] = torch.as_tensor(np.asarray(st.table), device=dev)
            j_n, co = st.mask.shape
            t["jj"] = torch.arange(j_n, device=dev)[:, None]
            t["ii"] = torch.arange(co, device=dev)[None, :]
        else:
            t["coef"] = c(st.coef)
        return t

    # ------------------------------------------------------------ kernel
    def _descriptors(self):
        ed = _engine_np(self.dtype)
        consts: List[np.ndarray] = []
        n_consts = 0
        lanes: List[List[np.ndarray]] = [[] for _ in _LANES]
        lane_len = [0] * len(_LANES)

        def add(a) -> int:
            nonlocal n_consts
            flat = np.asarray(a, np.int64).astype(ed).ravel()
            consts.append(flat)
            n_consts += flat.size
            return n_consts - flat.size

        desc = np.zeros((self.packed.n_stages(), N_FIELDS), np.int64)
        for k, st in enumerate(self.packed.stages):
            if len(st.epilogue) > MAX_EPI:
                raise PackError(f"stage {k} has {len(st.epilogue)} epilogue "
                                f"ops; the kernel takes at most {MAX_EPI}")
            d = desc[k]
            s_n, j_n = st.gather.shape
            d[F_KIND] = 0 if st.kind == "lut" else 1
            d[F_S], d[F_J], d[F_CO], d[F_NCOLS] = s_n, j_n, st.c_out, st.n_cols
            d[F_GATHER] = add(st.gather)
            d[F_BIAS] = add(st.bias)
            d[F_INSHIFT] = -1
            if st.kind == "lut":
                if st.in_shift is not None:
                    d[F_INSHIFT] = add(st.in_shift)
                d[F_MASK] = add(st.mask)
                table = np.ascontiguousarray(st.table)
                lane = _LANES.index(table.dtype)
                d[F_LANE], d[F_TOFF], d[F_E] = lane, lane_len[lane], table.shape[2]
                lanes[lane].append(table.ravel())
                lane_len[lane] += table.size
            else:
                d[F_COEF] = add(st.coef)
            d[F_NEPI] = len(st.epilogue)
            for m, e in enumerate(st.epilogue):
                d[F_EPI0 + 3 * m] = 0 if e.op == "REQUANT" else 1
                d[F_EPI0 + 3 * m + 1] = 1 if e.mode == "WRAP" else 0
                d[F_EPI0 + 3 * m + 2] = add(e.params)
        out_cols_off = add(self.packed.out_cols)
        tables = [np.concatenate(parts) if parts else None for parts in lanes]
        return desc, np.concatenate(consts), tables, out_cols_off

    def _upload(self, desc, consts, tables, out_cols_off):
        dev = self.device
        self.desc = torch.as_tensor(desc, device=dev)
        self.consts = torch.as_tensor(consts, device=dev)
        self.tables = [None if t is None else torch.as_tensor(t, device=dev)
                       for t in tables]
        self.out_cols_off = out_cols_off


def run_chain_plain(chain: PackedChain, x: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel B4: the stage loop in PyTorch.

    Computes what the reference's ``_make_kernel`` computes, stage for
    stage, on any device.  Table indices past a range-narrowed table are
    clamped to its last entry, as an out-of-range XLA gather is.
    """
    dtype = chain.dtype
    v = x
    for st, t in zip(chain.packed.stages, chain._plain):
        tb = v.shape[0]
        if bool((st.gather >= st.n_cols).any()):
            # implicit all-zero column at index n_cols (im2col pad)
            v = torch.cat([v, torch.zeros((tb, 1), dtype=v.dtype,
                                          device=v.device)], 1)
        g = v[:, t["gather"]]                               # (TB, S, J)
        if st.kind == "lut":
            code = (_shift_round(g[..., None], t["in_shift"])
                    if t["in_shift"] is not None else g[..., None])
            idx = (code & t["mask"]).long().clamp_(0, st.table.shape[2] - 1)
            vals = t["table"][t["jj"], t["ii"], idx].to(dtype)  # sign-extend
            acc = vals.sum(dim=2, dtype=dtype)                  # (TB, S, co)
        else:
            acc = (g * t["coef"][None]).sum(dim=-1, dtype=dtype)[..., None]
        acc = acc + t["bias"][None]
        for epi, p in zip(st.epilogue, t["epi"]):
            if epi.op == "REQUANT":
                res = _requant_cols(acc, p[..., 0][None], p[..., 1][None],
                                    (p[..., 2] != 0)[None], epi.mode)
                acc = torch.where((p[..., 3] != 0)[None], res, acc)
            else:                                               # CMUL
                acc = acc * p[None]
        v = acc.reshape(tb, -1)
    return v[:, chain._out_cols]


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("lut_serve")
        lib.lut_serve_chain.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.lut_serve_chain.restype = ctypes.c_int
        lib.lut_serve_descriptor_fields.restype = ctypes.c_int
        lib.lut_serve_max_epilogue.restype = ctypes.c_int
        lib.lut_serve_error_string.argtypes = [ctypes.c_int]
        lib.lut_serve_error_string.restype = ctypes.c_char_p
        if (lib.lut_serve_descriptor_fields() != N_FIELDS
                or lib.lut_serve_max_epilogue() != MAX_EPI):
            raise RuntimeError("csrc/lut_serve.cu and lut_serve_cuda.py "
                               "disagree on the stage descriptor layout")
        _LIB = lib
    return _LIB


def run_chain(chain: PackedChain, x: torch.Tensor) -> torch.Tensor:
    """Run the packed chain on ``x`` (B, n_cols0) codes -> (B, n_outputs).

    CPU tensors take :func:`run_chain_plain`; CUDA tensors launch kernel B4,
    once for the whole chain.
    """
    if x.device.type == "cpu":
        return run_chain_plain(chain, x)
    if x.device.type != "cuda":
        raise ValueError(f"run_chain: no kernel for device {x.device}")
    if x.device != chain.device:
        raise ValueError(f"x is on {x.device} but the chain on {chain.device}")
    if x.dtype != chain.dtype or x.dim() != 2 or x.shape[1] != chain.n_in:
        raise ValueError(f"x must be (B, {chain.n_in}) {chain.dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    batch = x.shape[0]
    if batch * max(chain.n_in, chain.n_out) >= 2 ** 31:
        raise ValueError(f"batch {batch} exceeds the kernel's 31-bit index range")
    out = torch.empty((batch, chain.n_out), dtype=chain.dtype, device=x.device)
    lib = _lib()
    tables = [0 if t is None else t.data_ptr() for t in chain.tables]
    rc = lib.lut_serve_chain(
        int(chain.dtype == torch.int64), x.data_ptr(), out.data_ptr(), batch,
        chain.n_in, chain.n_out, chain.desc.data_ptr(), chain.packed.n_stages(),
        chain.consts.data_ptr(), chain.out_cols_off, *tables, chain.tile_rows,
        chain.width, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lut_serve_chain launch failed: "
                           f"{lib.lut_serve_error_string(rc).decode()}")
    build.LAUNCHES["lut_serve"] += 1
    return out


def chain_runner(packed: PackedStages, dtype: torch.dtype, device):
    """``run(x)`` over ``packed`` lowered onto ``device`` (see :func:`run_chain`)."""
    chain = PackedChain(packed, dtype, device)
    return lambda x: run_chain(chain, x)
