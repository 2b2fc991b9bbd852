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
time (:func:`lower_chain`), to what the kernel interprets: a flat int64
descriptor array (a chain header, then one row per stage), one constants
buffer in the compute dtype and one table buffer per lane dtype, laid out in
a block's shared memory by the planner :func:`launch_plan`, which decides
which stages' tables are resident there; :func:`tile_plan` cuts each call's
batch into row tiles over a grid of at most SMs x resident blocks.
:func:`run_chain` is the wrapper: CPU tensors take the plain version
:func:`run_chain_plain` (the stage loop in PyTorch over the same packed
stages), CUDA tensors launch the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.lut_serve import (EpiOp, FusedStages, _requant_cols,
                                           _shift_round)

# Packed tables + stage constants may hold at most this many bytes.  Kept
# equal to the reference's VMEM budget so both packages pack and degrade on
# the same models.  On the H100 the tables that fit a block's shared memory
# are staged there (launch_plan); the rest are read through the 50 MB L2,
# where 8 MB stays resident beside the streaming batch.
DEF_VMEM_BUDGET = 8 << 20

# shared memory one block can use on the H100 (227 KB), and what an SM has,
# of which the runtime reserves SMEM_RESERVED a block
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
# tile rows: room for at least MIN_TILE_ROWS is kept before any table is
# made resident, and a tile holds at most MAX_TILE_ROWS
MIN_TILE_ROWS = 32
MAX_TILE_ROWS = 256
# threads of a block, and outputs c of a warp's unit (csrc/lut_serve.cu's
# kThreads and CC; _lib checks both)
THREADS = 512
OUTPUTS_PER_WARP = 4

_LANES = (np.dtype(np.int8), np.dtype(np.int16), np.dtype(np.int32),
          np.dtype(np.int64))
# the chain header and the stage descriptor fields, in the order of enum
# Header and enum Field in csrc/lut_serve.cu
(H_NSTAGES, H_NIN, H_NOUT, H_OUTCOLS, H_CSOFF, H_NCOPIES, H_BARSOFF, H_NBAR,
 H_BUFSOFF, H_STRIDEA, H_STRIDEB, H_CONSTS, H_T8, H_T16, H_T32, H_T64) = range(16)
N_HEADER = 16
(F_KIND, F_S, F_J, F_CO, F_E, F_GATHER, F_BIAS, F_INSHIFT, F_MASK, F_COEF,
 F_LANE, F_TOFF, F_SOFF, F_BAR, F_FASTMASK, F_NEPI, F_EPI0) = range(17)
MAX_EPI = 4
N_FIELDS = F_EPI0 + 3 * MAX_EPI
# after the stage rows, one row per bulk copy: shared byte offset, device
# address of the source, bytes, mbarrier
COPY_FIELDS = 4

_BLOCKS_PER_SM: Dict[Tuple[int, int], int] = {}   # (device, variant) -> occupancy


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
class ChainPlan(NamedTuple):
    """Where kernel B4 keeps a chain in a block's shared memory (byte
    offsets, each a multiple of 16), decided once per chain by
    :func:`launch_plan`: the constants, the resident stages' tables, one
    mbarrier per bulk copy (the constants', each resident stage's), then the
    two tile buffers."""

    consts_soff: int                # -1: the constants are read from global memory
    table_soff: Tuple[int, ...]     # per stage; -1: its tables are read from global memory
    table_bar: Tuple[int, ...]      # per stage: the mbarrier its copy completes, or -1
    n_bar: int
    bar_soff: int
    buf_soff: int                   # tile buffer A, then B
    stride_a: int                   # row strides of the buffers, odd, in elements
    stride_b: int
    row_bytes: int                  # both buffers' bytes per tile row
    max_tile_rows: int

    def smem(self, tile_rows: int) -> int:
        """Dynamic shared memory of a block with tiles of ``tile_rows``."""
        return self.buf_soff + tile_rows * self.row_bytes


class TilePlan(NamedTuple):
    tile_rows: int     # rows of every tile but the last
    n_tiles: int
    grid: int          # blocks; block b walks the tiles b, b + grid, ...
    smem: int          # dynamic shared memory of a block, bytes


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _odd_at_least(n: int) -> int:
    return n | 1


def launch_plan(packed: PackedStages, itemsize: int, consts_bytes: int,
                smem_budget: int = SMEM_PER_BLOCK) -> ChainPlan:
    """Lay the chain out in a block's shared memory.

    The tile buffers come first in the budget: room for ``MIN_TILE_ROWS``
    rows of both is kept.  Then the constants (``consts_bytes``, a multiple
    of 16) are resident if they fit, then each lut stage's tables in chain
    order, each if it fits in what is left (one that does not keeps the
    global path; a later, smaller one may still fit).  The tile rows that
    remain, up to ``MAX_TILE_ROWS`` and a multiple of 32 where at least 32
    fit, bound the tiles.  Raises :exc:`PackError` when not one row of the
    two tile buffers fits.
    """
    widths = [packed.n_cols0] + [st.n_sites * st.c_out for st in packed.stages]
    # buffer A holds the inputs of even stages, B of odd ones; one more
    # column holds the gather's zero column
    stride_a = _odd_at_least(max(widths[0::2]) + 1)
    stride_b = _odd_at_least(max(widths[1::2], default=0) + 1)
    row_bytes = (stride_a + stride_b) * itemsize
    if row_bytes > smem_budget - 16:
        raise PackError(f"a {max(widths)}-wide stage row does not fit one "
                        f"block's shared memory twice")
    keep = min(MIN_TILE_ROWS, (smem_budget - 16) // row_bytes) * row_bytes

    def fits(used: int, n_bar: int) -> bool:
        return used + _round16(8 * n_bar) + keep <= smem_budget

    used, n_bar, consts_soff = 0, 0, -1
    if fits(consts_bytes, 1):
        consts_soff, used, n_bar = 0, consts_bytes, 1
    soffs, bars = [], []
    for st in packed.stages:
        soff, bar = -1, -1
        if st.kind == "lut" and st.table.size:
            seg = _round16(st.table.nbytes)
            if fits(used + seg, n_bar + 1):
                soff, bar = used, n_bar
                used, n_bar = used + seg, n_bar + 1
        soffs.append(soff)
        bars.append(bar)
    bar_soff = used
    buf_soff = used + _round16(8 * n_bar)
    max_rows = min(MAX_TILE_ROWS, (smem_budget - buf_soff) // row_bytes)
    if max_rows >= 32:
        max_rows -= max_rows % 32
    return ChainPlan(consts_soff, tuple(soffs), tuple(bars), n_bar,
                     bar_soff, buf_soff, stride_a, stride_b, row_bytes, max_rows)


def blocks_per_sm(plan: ChainPlan, by_threads: int) -> int:
    """Resident blocks an SM holds: ``by_threads`` (the occupancy query, by
    threads and registers), fewer where a block's shared memory at the
    largest tile allows fewer."""
    return max(1, min(by_threads,
                      SMEM_PER_SM // (plan.smem(plan.max_tile_rows) + SMEM_RESERVED)))


def tile_plan(plan: ChainPlan, batch: int, blocks: int) -> TilePlan:
    """Tiles and grid of a call of ``batch`` rows on a card that holds
    ``blocks`` blocks at once: each block's rows (the batch over the blocks)
    cut into the fewest tiles of at most ``plan.max_tile_rows``, rounded up
    to whole groups of 32 rows, and no more blocks than tiles."""
    per_block = -(-batch // blocks)
    n_per = -(-per_block // plan.max_tile_rows)
    tile = -(-per_block // n_per)
    if plan.max_tile_rows >= 32:
        tile = min(-(-tile // 32) * 32, plan.max_tile_rows)
    n_tiles = -(-batch // tile)
    return TilePlan(tile, n_tiles, min(blocks, n_tiles), plan.smem(tile))


def _fast_mask(st: PackedStage) -> int:
    """The one mask of a lut stage whose lookups take the kernel's fast path
    (no in-shift, every cell's mask the same and inside the table, so no
    index needs the clamp, and each site gathering contiguous columns), or
    -1."""
    if st.in_shift is not None or not st.mask.size:
        return -1
    m = int(st.mask.flat[0])
    contiguous = (st.gather - st.gather[:, :1] == np.arange(st.gather.shape[1])).all()
    if contiguous and (st.mask == m).all() and 0 <= m < st.table.shape[2]:
        return m
    return -1


class ChainLowering(NamedTuple):
    """What kernel B4 reads of a chain, before it is on a device."""

    desc: np.ndarray               # header, stage rows, copy rows (sources left 0), int64
    consts: np.ndarray             # compute dtype, padded to a multiple of 16 bytes
    tables: List[Optional[np.ndarray]]   # per lane dtype, segments padded to 16 bytes
    plan: ChainPlan
    copies: np.ndarray             # (n, 5): shared offset, source (-1 consts, else a
                                   # lane), byte offset in it, bytes, mbarrier


def lower_chain(packed: PackedStages, dtype: torch.dtype) -> ChainLowering:
    """Lower ``packed`` to the kernel's descriptors, constants and lane
    table buffers, laid out by :func:`launch_plan`.  The header's device
    addresses (``H_CONSTS``, ``H_T8`` ...) are left 0 for the caller that
    uploads the buffers.  Raises :exc:`PackError` for a chain the kernel
    cannot run (more than ``MAX_EPI`` epilogue ops in a stage, a gather
    outside ``[0, n_cols]``, rows wider than a block's shared memory)."""
    ed = _engine_np(dtype)
    itemsize = np.dtype(ed).itemsize
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

    stages = np.zeros((packed.n_stages(), N_FIELDS), np.int64)
    for k, st in enumerate(packed.stages):
        if len(st.epilogue) > MAX_EPI:
            raise PackError(f"stage {k} has {len(st.epilogue)} epilogue "
                            f"ops; the kernel takes at most {MAX_EPI}")
        if st.gather.size and (st.gather.min() < 0 or st.gather.max() > st.n_cols):
            raise PackError(f"stage {k} gathers outside [0, {st.n_cols}]")
        d = stages[k]
        s_n, j_n = st.gather.shape
        d[F_KIND] = 0 if st.kind == "lut" else 1
        d[F_S], d[F_J], d[F_CO] = s_n, j_n, st.c_out
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
            pad = -table.size % (16 // table.dtype.itemsize)   # the next segment 16-aligned
            lanes[lane] += [table.ravel(), np.zeros(pad, table.dtype)]
            lane_len[lane] += table.size + pad
        else:
            d[F_COEF] = add(st.coef)
        d[F_NEPI] = len(st.epilogue)
        for m, e in enumerate(st.epilogue):
            d[F_EPI0 + 3 * m] = 0 if e.op == "REQUANT" else 1
            d[F_EPI0 + 3 * m + 1] = 1 if e.mode == "WRAP" else 0
            d[F_EPI0 + 3 * m + 2] = add(e.params)
    out_cols_off = add(packed.out_cols)
    consts.append(np.zeros(-n_consts % (16 // itemsize) if n_consts else 16 // itemsize, ed))
    flat = np.concatenate(consts)
    plan = launch_plan(packed, itemsize, flat.nbytes)
    stages[:, F_SOFF] = plan.table_soff
    stages[:, F_BAR] = plan.table_bar
    stages[:, F_FASTMASK] = [_fast_mask(st) if soff >= 0 else -1
                             for st, soff in zip(packed.stages, plan.table_soff)]
    # the bulk copies: the constants, then each resident stage's tables
    copies = []
    if plan.consts_soff >= 0:
        copies.append((plan.consts_soff, -1, 0, flat.nbytes, 0))
    for st, d in zip(packed.stages, stages):
        if d[F_SOFF] >= 0:
            copies.append((int(d[F_SOFF]), int(d[F_LANE]), int(d[F_TOFF]) * st.table.itemsize,
                           _round16(st.table.nbytes), int(d[F_BAR])))
    copies = np.asarray(copies, np.int64).reshape(-1, 5)
    head = np.zeros(N_HEADER, np.int64)
    head[H_NSTAGES], head[H_NIN], head[H_NOUT] = (packed.n_stages(), packed.n_cols0,
                                                  len(packed.out_cols))
    head[H_OUTCOLS], head[H_CSOFF], head[H_NCOPIES] = (out_cols_off, plan.consts_soff,
                                                       len(copies))
    head[H_BARSOFF], head[H_NBAR], head[H_BUFSOFF] = plan.bar_soff, plan.n_bar, plan.buf_soff
    head[H_STRIDEA], head[H_STRIDEB] = plan.stride_a, plan.stride_b
    rows = np.zeros((len(copies), COPY_FIELDS), np.int64)
    rows[:, 0], rows[:, 2], rows[:, 3] = copies[:, 0], copies[:, 3], copies[:, 4]
    tables = [np.concatenate(parts) if parts else None for parts in lanes]
    return ChainLowering(np.concatenate([head, stages.ravel(), rows.ravel()]), flat, tables,
                         plan, copies)


class PackedChain:
    """A :class:`PackedStages` chain lowered once onto ``device``.

    Holds the per-stage tensors the plain version reads and, on a CUDA
    device, the descriptors, constants and lane-table buffers kernel B4
    interprets, with the chain's launch plan for that card.  Raises
    :exc:`PackError` when a chain cannot run as one launch
    (:func:`lower_chain`).
    """

    def __init__(self, packed: PackedStages, dtype: torch.dtype, device):
        if dtype not in (torch.int32, torch.int64):
            raise ValueError(f"chain dtype must be int32 or int64, got {dtype}")
        self.packed, self.dtype = packed, dtype
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # where torch places a tensor asked for on "cuda"
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_in, self.n_out = packed.n_cols0, len(packed.out_cols)
        self._plain = [self._plain_stage(st) for st in packed.stages]
        self._out_cols = torch.as_tensor(packed.out_cols, device=self.device)
        widths = [packed.n_cols0] + [st.n_sites * st.c_out for st in packed.stages]
        for k, st in enumerate(packed.stages):
            if st.n_cols != widths[k]:
                raise PackError(f"stage {k} reads {st.n_cols} columns but its "
                                f"input has {widths[k]}")
        low = lower_chain(packed, dtype)
        self.plan = low.plan
        if self.device.type == "cuda":
            self._upload(low)

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
    def _upload(self, low: ChainLowering):
        dev = self.device
        self.consts = torch.as_tensor(low.consts, device=dev)
        self.tables = [None if t is None else torch.as_tensor(t, device=dev)
                       for t in low.tables]
        desc = low.desc.copy()
        base = [0 if t is None else t.data_ptr() for t in self.tables]
        desc[H_CONSTS] = self.consts.data_ptr()
        desc[H_T8:H_T64 + 1] = base
        rows = desc[N_HEADER + len(self.packed.stages) * N_FIELDS:].reshape(-1, COPY_FIELDS)
        for row, (_, src, off, _, _) in zip(rows, low.copies):
            row[1] = (self.consts.data_ptr() if src < 0 else base[src]) + off
        self.desc = torch.as_tensor(desc, device=dev)
        self.variant = 2 * int(self.dtype == torch.int64) + int(self.plan.consts_soff >= 0)
        lib = _lib()
        key = (dev.index, self.variant)
        occ = _BLOCKS_PER_SM.get(key)
        if occ is None:
            with torch.cuda.device(dev):
                occ = lib.lut_serve_blocks_per_sm(self.variant)
            if occ < 1:
                raise RuntimeError("lut_serve: the occupancy query failed")
            _BLOCKS_PER_SM[key] = occ
        self.blocks = (torch.cuda.get_device_properties(dev).multi_processor_count
                       * blocks_per_sm(self.plan, occ))
        self._tiles: Dict[int, TilePlan] = {}

    def tiles(self, batch: int) -> TilePlan:
        """The tile plan of a call of ``batch`` rows, computed once."""
        t = self._tiles.get(batch)
        if t is None:
            t = self._tiles[batch] = tile_plan(self.plan, batch, self.blocks)
        return t


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


def _bind(lib: ctypes.CDLL) -> None:
    lib.lut_serve_chain.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lut_serve_chain.restype = ctypes.c_int
    lib.lut_serve_blocks_per_sm.argtypes = [ctypes.c_int]
    layout = (lib.lut_serve_header_fields, lib.lut_serve_descriptor_fields,
              lib.lut_serve_copy_fields, lib.lut_serve_max_epilogue,
              lib.lut_serve_threads, lib.lut_serve_outputs_per_warp)
    for fn in (lib.lut_serve_blocks_per_sm, *layout):
        fn.restype = ctypes.c_int
    lib.lut_serve_error_string.argtypes = [ctypes.c_int]
    lib.lut_serve_error_string.restype = ctypes.c_char_p
    if tuple(fn() for fn in layout) != (N_HEADER, N_FIELDS, COPY_FIELDS, MAX_EPI,
                                        THREADS, OUTPUTS_PER_WARP):
        raise RuntimeError("csrc/lut_serve.cu and lut_serve_cuda.py "
                           "disagree on the descriptor or block layout")


def _lib() -> ctypes.CDLL:
    return build.load("lut_serve", _bind)


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
    if batch == 0:
        return out
    t = chain.tiles(batch)
    lib = _lib()
    rc = lib.lut_serve_chain(
        chain.variant, x.data_ptr(), out.data_ptr(), batch, chain.desc.data_ptr(),
        t.tile_rows, t.n_tiles, t.grid, t.smem,
        torch._C._cuda_getCurrentRawStream(chain.device.index))   # the current stream
    if rc != 0:
        raise RuntimeError(f"lut_serve_chain launch failed: "
                           f"{lib.lut_serve_error_string(rc).decode()}")
    build.count_launch("lut_serve")
    return out


def chain_runner(packed: PackedStages, dtype: torch.dtype, device):
    """``run(x)`` over ``packed`` lowered onto ``device`` (see :func:`run_chain`)."""
    chain = PackedChain(packed, dtype, device)
    return lambda x: run_chain(chain, x)
