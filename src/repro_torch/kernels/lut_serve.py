"""Integer LUT serving engine, port of ``repro.kernels.lut_serve``.

``core/dais.py`` interprets a compiled :class:`DaisProgram` one scalar
instruction at a time in numpy — the verification oracle.  This module lowers
the same program to a serving engine on the device:

* **the packed chain** (``engine="pallas"``, the default preference of
  ``launch/serve.py --engine pallas``): the composed stages are packed
  (``kernels/lut_serve_cuda.py``) and run by kernel B4, the whole chain in
  one launch;
* **the fused path** (``engine="fused"``): every layer is one
  :class:`FusedStage` run as per-site gather → requant → batched table
  gather → Σ → epilogue in PyTorch integer ops;
* **the generic op-group path** (``engine="groups"``, and anything the
  composer rejects: non-chain dataflow, un-enumerable operand widths, a
  one-window pid context): ``DaisProgram.schedule()`` levelizes the SSA
  program into :class:`~repro_torch.core.dais.OpGroup` s and each group
  becomes a handful of PyTorch integer ops over ``(B, n_group)`` values —
  LLUT a flat table gather with the WRAP index, REQUANT the column-parallel
  ``_requant_cols``, ADD/SUB/CMUL/CONST exact integer arithmetic.  Its op
  count scales with program depth, so a batch is host-bound at a few ops a
  group; it runs no custom kernel (the reference's is plain ``jnp`` too).

Unavailable preferences degrade ``pallas → fused → generic``, each
downgrade named by an :class:`EnginePathWarning` and kept on
``ServeEngine.fuse_reason``, as in the reference.  :func:`lower_tables` is
the single-layer gather engine (one ``LayerTables`` on its own).

Values are int32 when the static range analysis (``core/analysis.py``)
proves every value the engine materializes fits 30 bits (the proven
:func:`engine_width`, or the conservative ``required_width()`` when the
analysis is unavailable or ``narrow=False``), else int64.
:func:`verify_engine` is the bit-exactness gate against ``DaisProgram.run``.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.analysis import (_round_half_even, analyze_ranges,
                                       index_window)
from repro_torch.core.dais import DaisProgram, OpGroup, _requant
from repro_torch.core.tables import LayerTables

logger = logging.getLogger(__name__)

# int32 holds any value chain whose proven width is <= 30 bits: REQUANT's
# 2**width span and the wrap offset ``code - lo`` both stay under 2**31
_INT32_MAX_WIDTH = 30


def _pick_dtype(width: int) -> torch.dtype:
    return torch.int32 if width <= _INT32_MAX_WIDTH else torch.int64


def _check_dtype(dtype: torch.dtype, width: int) -> None:
    """Reject an explicitly requested int32 that the program overflows."""
    if dtype not in (torch.int32, torch.int64):
        raise ValueError(f"engine dtype must be torch.int32 or torch.int64, "
                         f"got {dtype}")
    if width > _INT32_MAX_WIDTH and dtype == torch.int32:
        raise ValueError(
            f"program has {width}-bit registers/transients but the requested "
            f"engine dtype int32 covers <= {_INT32_MAX_WIDTH} bits — values "
            f"would overflow-wrap; pass dtype=None or torch.int64")


def _device_ints(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """An integer constant array as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(np.asarray(arr, np.int64), device=device).to(dtype)


def _ranges(prog: DaisProgram):
    """The interval analysis of ``prog``, or None when it cannot be made."""
    try:
        return analyze_ranges(prog)
    except (ValueError, IndexError, KeyError) as e:  # unanalyzable program
        logger.debug("range analysis unavailable (%s); "
                     "falling back to required_width", e)
        return None


def engine_width(prog: DaisProgram) -> int:
    """Width bound the engine dtype is sized from: the proven
    ``ValueRanges.engine_width()`` when the analysis succeeds, else the
    conservative ``DaisProgram.required_width()``."""
    ranges = _ranges(prog)
    return ranges.engine_width() if ranges is not None else prog.required_width()


class EnginePathWarning(UserWarning):
    """A preferred engine lowering was unavailable and compile fell back."""


class EngineRequirementError(RuntimeError):
    """A ``require=`` spec was not met (engine compiled on a lower path)."""


# --------------------------------------------------------------------------- #
# integer requant (port of core.dais._requant, column-parallel)
# --------------------------------------------------------------------------- #
def _shift_round(v: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``v * 2**shift`` on integer codes, round-half-to-even on dropped bits.

    ``shift`` broadcasts against ``v`` and may mix signs.  Shift amounts at
    or past the dtype width give 0 (left) or the sign fill (right), as in
    XLA, so the results match the reference's jnp version bit for bit.
    """
    one = torch.ones((), dtype=v.dtype, device=v.device)
    up = v << torch.clamp(shift, min=0)
    s = torch.clamp(-shift, min=0)
    floor = v >> s
    rem = v - (floor << s)
    half = (one << torch.clamp(s, min=1)) >> 1
    down = torch.where(rem > half, floor + 1,
                       torch.where(rem < half, floor, floor + (floor & 1)))
    return torch.where(shift >= 0, up, down)


def _requant_cols(v, shift, width, signed, mode: str) -> torch.Tensor:
    """Re-quantize ``v`` onto new grids (per-column ``shift``/``width``/
    ``signed``, shared overflow ``mode``), bit-exactly as ``_requant``."""
    one = torch.ones((), dtype=v.dtype, device=v.device)
    code = _shift_round(v, shift)
    n_codes = one << torch.clamp(width, min=0)
    lo = torch.where(signed, -(n_codes >> 1), torch.zeros_like(n_codes))
    hi = lo + n_codes - 1
    if mode == "SAT":
        out = torch.minimum(torch.maximum(code, lo), hi)
    else:  # WRAP: grids are powers of two, so mod is a two's-complement mask
        out = lo + ((code - lo) & (n_codes - 1))
    return torch.where(width > 0, out, torch.zeros_like(out))


# --------------------------------------------------------------------------- #
# program engine
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ServeEngine:
    """A compiled integer runtime for one :class:`DaisProgram` on a device."""

    n_inputs: int
    n_outputs: int
    n_groups: int               # op groups (generic), stages (fused) or
                                # packed stages (pallas)
    dtype: torch.dtype
    device: torch.device
    path: str                   # "pallas" | "fused" | "generic"
    fuse_reason: str            # downgrade reason(s); "" when preferred ran
    output_f: List[int]
    _runner: Callable
    n_launches: int = 0         # launches per batch (pallas: 1; fused /
                                # generic: one op bundle per stage / group)
    packed_table_bytes: int = 0  # lane-packed table bytes ("pallas" only)

    def run(self, x_codes) -> torch.Tensor:
        """(B, n_inputs) integer codes -> (B, n_outputs) codes on the device.

        Same contract as ``DaisProgram.run`` (grids ``input_f`` in,
        ``output_f`` out).
        """
        x = torch.as_tensor(x_codes, device=self.device).to(self.dtype)
        if x.dim() == 1:
            x = x[None]
        return self._runner(x.contiguous())

    def clone(self) -> "ServeEngine":
        """A replica-local handle sharing this engine's compiled runner.

        The runner's device constants (and kernel B4's lowered chain) are
        read-only and shared; the clone is its own dataclass instance, so
        each serving-tier replica holds its own handle instead of N threads
        aliasing one.  Used by ``repro_torch.serve.tier.ServeTier``.
        """
        return dataclasses.replace(self)

    def warm(self, batch_sizes) -> List[int]:
        """Run all-zero codes (always in range) through every batch size in
        ``batch_sizes`` and wait for the device; returns the sizes warmed.

        The micro-batching scheduler pads every flush to a power-of-two
        bucket and calls this at ``start()`` with the bucket ladder, so each
        bucket's first launch (and its tile plan, ``PackedChain.tiles``)
        happens here, never on a request.  Kernel B4's library is built and
        loaded earlier still, when the engine lowers its chain onto the card.
        """
        warmed = []
        for b in batch_sizes:
            self.run(np.zeros((int(b), self.n_inputs), np.int64))
            warmed.append(int(b))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed


def compile_program(prog: DaisProgram, *, device="cuda",
                    dtype: Optional[torch.dtype] = None,
                    engine: Optional[str] = "fused",
                    stages: Optional["FusedStages"] = None,
                    packed: Optional[object] = None,
                    narrow: bool = True) -> ServeEngine:
    """Lower a DAIS program to a serving engine on ``device``.

    ``engine``: ``"pallas"`` prefers the packed chain of kernel B4 (one
    launch per batch), ``"fused"`` (or ``None``) the composed stages in
    PyTorch integer ops, ``"groups"`` forces the generic op-group runner.
    Unavailable preferences degrade ``pallas -> fused -> generic``; every
    downgrade raises an :class:`EnginePathWarning`, is logged, and is kept
    on ``ServeEngine.fuse_reason``, with the chosen lowering on
    ``ServeEngine.path``.

    ``stages``: pre-composed :class:`FusedStages` (from a compiled-artifact
    bundle) — the composition pass is skipped.  ``packed``: a pre-packed
    :class:`~repro_torch.kernels.lut_serve_cuda.PackedStages` (a bundle's
    v3 payload, packed with int64 arithmetic) — ``pack_stages`` is skipped
    and the payload is lowered at the engine's dtype, whose two's-complement
    wrap makes it equal to a chain packed at that dtype.

    ``narrow``: run the static interval analysis (``core/analysis.py``) to
    size the engine dtype from the proven :func:`engine_width` bound and
    hand the chain packer per-stage ``live`` entry masks that shrink table
    lanes.  ``narrow=False`` sizes the dtype from ``required_width()`` and
    packs full rows: the baseline of the reference's lane-narrowing rows.
    Given ``stages`` there is no analysis, as in the reference: the dtype
    comes from ``required_width()`` and the stored payload keeps the lanes
    it was saved with.
    """
    want = "fused" if engine is None else engine
    if want not in ("pallas", "fused", "groups"):
        raise ValueError(
            f"unknown engine {want!r} (choices: pallas, fused, groups)")
    device = torch.device(device)
    ranges = _ranges(prog) if narrow and stages is None else None
    # engine_width/required_width cover transient pre-clamp REQUANT /
    # pre-add align values, which can exceed every declared register width
    width_bound = (ranges.engine_width() if ranges is not None
                   else prog.required_width())
    if dtype is None:
        dtype = _pick_dtype(width_bound)
    else:
        _check_dtype(dtype, width_bound)

    run, stages, reason = None, None, ""
    downgrades: List[str] = []
    packed_bytes = 0
    if want in ("pallas", "fused") and stages is None:
        stages, reason = compose_fused_stages(prog, ranges=ranges)
    if want == "pallas":
        if stages is None:
            downgrades.append(f"pallas (and fused) unavailable: {reason}")
        else:
            from repro_torch.kernels import lut_serve_cuda as _chain
            try:
                if packed is None:
                    packed = _chain.pack_stages(stages, dtype)
                run = _chain.chain_runner(packed, dtype, device)
                path, n_groups, n_launches = "pallas", packed.n_stages(), 1
                packed_bytes = packed.table_bytes()
            except _chain.PackError as e:
                downgrades.append(f"pallas unavailable: {e}")
    if run is None and want in ("pallas", "fused") and stages is not None:
        run, path = _fused_runner(stages, dtype, device), "fused"
        n_groups = n_launches = stages.n_stages()
    elif run is None and want == "fused":
        downgrades.append(f"fused unavailable: {reason}")
    if run is None:
        run, n_groups = _group_runner(prog, dtype, device)
        path, n_launches = "generic", n_groups
    if downgrades:
        msg = f"engine path downgraded to {path!r}: " + "; ".join(downgrades)
        warnings.warn(EnginePathWarning(msg), stacklevel=2)
        logger.warning("%s", msg)

    return ServeEngine(
        n_inputs=len(prog.input_f), n_outputs=len(prog.outputs),
        n_groups=n_groups, dtype=dtype, device=device, path=path,
        fuse_reason="; ".join(downgrades), output_f=list(prog.output_f),
        _runner=run, n_launches=n_launches, packed_table_bytes=packed_bytes)


# --------------------------------------------------------------------------- #
# generic path: one op bundle per scheduled OpGroup
# --------------------------------------------------------------------------- #
def _group_runner(prog: DaisProgram, dtype: torch.dtype, device):
    """Generic lowering: one vectorized op bundle per scheduled OpGroup.

    Each group's result stays its own ``(B, n_group)`` tensor; a consuming
    group gathers its arguments from the concatenation of just the source
    groups it references (usually one or two — the level structure keeps
    fan-in local), so there is no global register matrix to recopy.
    """
    groups = prog.schedule()
    group_of = np.full(len(prog.instrs), -1, np.int64)
    col_in_group = np.full(len(prog.instrs), -1, np.int64)
    for gi, g in enumerate(groups):
        for c, r in enumerate(g.regs):
            group_of[r] = gi
            col_in_group[r] = c
    sizes = [len(g.regs) for g in groups]

    def locate(regs):
        """Source-group set + local columns of ``regs`` within their concat;
        the columns are an int64 tensor made once on ``device``."""
        srcs = sorted({int(group_of[r]) for r in regs})
        off, acc = {}, 0
        for s in srcs:
            off[s] = acc
            acc += sizes[s]
        cols = np.asarray([off[int(group_of[r])] + int(col_in_group[r])
                           for r in regs], np.int64)
        return srcs, torch.as_tensor(cols, device=device)

    prepared = [_prepare_group(prog, g, locate, dtype, device) for g in groups]
    out_srcs, out_cols = locate(prog.outputs)

    def _assemble(results, srcs):
        if len(srcs) == 1:
            return results[srcs[0]]
        return torch.cat([results[s] for s in srcs], 1)

    def run(x):
        results = []
        for srcs, ex in prepared:
            results.append(ex(_assemble(results, srcs) if srcs else None, x))
        return _assemble(results, out_srcs)[:, out_cols]
    return run, len(groups)


def _prepare_group(prog: DaisProgram, g: OpGroup, locate, dtype: torch.dtype,
                   device):
    """Close a single OpGroup over its device constants.

    Returns ``(srcs, ex)``: ``srcs`` are the indices of the earlier groups
    this one reads from, and ``ex(base, x) -> (B, n)`` computes the group
    from ``base`` — the (B, Σ sizes) concatenation of those groups' results
    — and the (B, n_inputs) input codes ``x``.  No ``ex`` writes into its
    inputs: a CONST group's result is an expanded view.
    """
    a = g.args

    def dev(arr):
        return _device_ints(arr, dtype, device)

    if g.op == "IN":
        ks = torch.as_tensor(np.asarray(a["k"], np.int64), device=device)
        return [], lambda base, x: x[:, ks]

    if g.op == "CONST":
        cs = dev(a["c"])
        return [], lambda base, x: cs[None].expand(x.shape[0], -1)

    if g.op == "REQUANT":
        srcs, src = locate(a["src"])
        shift = dev(a["f"] - a["src_f"])
        width = dev(a["f"] + a["i"] + a["signed"])
        signed = torch.as_tensor(np.asarray(a["signed"]) != 0, device=device)
        mode = g.mode
        return srcs, lambda base, x: _requant_cols(base[:, src], shift, width,
                                                   signed, mode)

    if g.op == "LLUT":
        srcs, src = locate(a["src"])
        n = len(src)
        sizes_np = np.empty(n, np.int64)
        rows = []
        for col in range(n):
            t = prog.tables[int(a["layer"][col])]
            j, i = int(a["j"][col]), int(a["i"][col])
            sizes_np[col] = t.entry_sizes()[j, i]
            rows.append(np.asarray(t.codes[j, i], np.int64))
        e_max = int(sizes_np.max())
        table = np.zeros((n, e_max), np.int64)
        for col, row in enumerate(rows):
            table[col, :min(len(row), e_max)] = row[:e_max]
        table_d = dev(table).reshape(-1)
        masks = dev(sizes_np - 1)
        # row offsets into the flattened (n, e_max) table, int64 on device
        row_off = torch.arange(n, device=device, dtype=torch.int64) * e_max

        def ex(base, x):
            # WRAP contract (tables.py): idx = code mod 2**m == code & (2**m-1)
            idx = base[:, src] & masks
            return table_d[idx.long() + row_off]
        return srcs, ex

    if g.op == "CMUL":
        srcs, src = locate(a["src"])
        codes = dev(a["code"])
        return srcs, lambda base, x: base[:, src] * codes[None]

    # ADD / SUB — locate both operand sets against one shared base
    n = len(a["a"])
    srcs, cols = locate(list(a["a"]) + list(a["b"]))
    ca, cb = cols[:n], cols[n:]
    sa, sb = dev(a["shift_a"]), dev(a["shift_b"])
    if g.op == "ADD":
        return srcs, lambda base, x: (base[:, ca] << sa) + (base[:, cb] << sb)
    return srcs, lambda base, x: (base[:, ca] << sa) - (base[:, cb] << sb)


# --------------------------------------------------------------------------- #
# fused per-layer path: tables composed once per layer, gathered per site
# --------------------------------------------------------------------------- #
# Caps on what the composer will enumerate: one stage's table may not exceed
# _MAX_COMPOSED_ELEMS entries, and a single operand chain is only enumerated
# when its input register is at most _MAX_ENUM_WIDTH bits wide.
_MAX_COMPOSED_ELEMS = 1 << 24
_MAX_ENUM_WIDTH = 20


class _ComposeError(Exception):
    """Raised inside the composer; the message is the fall-back reason."""


@dataclasses.dataclass
class EpiOp:
    """One vectorized per-channel epilogue op applied after a stage's Σ.

    ``REQUANT``: ``params`` is ``(S, co, 4)`` = (grid shift, width, signed,
    apply) with the overflow ``mode`` shared — ``apply == 0`` marks
    channels whose output folded entirely into their term/bias (no
    epilogue instruction), which pass through untouched; ``CMUL``:
    ``params`` is ``(S, co)`` constant codes (1 = pass-through).
    """

    op: str                      # "REQUANT" | "CMUL"
    mode: str                    # REQUANT overflow mode; "" for CMUL
    params: np.ndarray


@dataclasses.dataclass
class FusedStage:
    """One layer of the fused runner, shared tables + per-site gathers.

    ``gather`` is ``(S, J)``: for each of the layer's ``S`` spatial sites,
    the ``J`` columns of the incoming flat value matrix it reads (the value
    ``n_cols`` addresses an implicit all-zero column — the im2col zero
    pad).  Kind "lut" then computes, per cell ``(j, i)``,
    ``table[j, i, mask & shift_round(v)] << out_shift`` and sums over
    ``j`` — the table is stored **once** and indexed by every site, which
    is the whole point of the shared-table lowering.  Kind "sum" is the
    table-free variant (window accumulation, standalone relu):
    ``Σ_j sign * (v << shift)``.  Both add ``bias`` and then apply the
    ``epilogue`` ops (e.g. an HGQ layer's relu clamp).  The stage output is
    ``(B, S, co)`` reshaped to the next stage's flat ``(B, S*co)``.
    """

    kind: str                    # "lut" | "sum"
    gather: np.ndarray           # (S, J) int64; == n_cols -> zero column
    n_cols: int                  # incoming flat width
    bias: np.ndarray             # (S, co) int64
    epilogue: List[EpiOp] = dataclasses.field(default_factory=list)
    # kind "lut"
    in_shift: Optional[np.ndarray] = None   # (J, co) grid shifts
    mask: Optional[np.ndarray] = None       # (J, co) index masks
    table: Optional[np.ndarray] = None      # (J, co, E) int64, site-shared
    out_shift: Optional[np.ndarray] = None  # (J, co) alignment shifts
    # kind "sum"
    shifts: Optional[np.ndarray] = None     # (S, J) alignment shifts
    signs: Optional[np.ndarray] = None      # (S, J) in {-1, 0, +1}
    # kind "lut", optional: (J, co, E) bool — entries the range analysis
    # proves reachable.  Compile-time metadata only: the chain packer
    # (kernels/lut_serve_cuda.py) zeroes dead entries before lane selection.
    live: Optional[np.ndarray] = None

    @property
    def n_sites(self) -> int:
        return self.gather.shape[0]

    @property
    def c_out(self) -> int:
        return self.bias.shape[1]


@dataclasses.dataclass
class FusedStages:
    """The compile-time product of the fused path, as plain data.

    One :class:`FusedStage` per graph layer plus the output column
    selection: everything the fused runner and the chain packer read.
    """

    stages: List[FusedStage]
    out_cols: np.ndarray         # (n_outputs,) columns of the final stage

    def n_stages(self) -> int:
        return len(self.stages)


# ---------------------------------------------------------------- composer
def _reg_fmt(prog: DaisProgram, r: int):
    reg = prog.instrs[r].reg
    return (reg.f, max(reg.width, 1), reg.signed)


_MIXED_FMT = "mixed"


def _stage_gather(prog: DaisProgram, segs, colmap, n_cols):
    """Per-site column gather + per-position incoming formats.

    Registers absent from ``colmap`` must be zero CONSTs (the im2col pads)
    and map to the implicit zero column ``n_cols``.  A position whose
    format differs across sites reports the :data:`_MIXED_FMT` sentinel —
    only table-building stage kinds need uniform formats (the
    chain-as-epilogue and table-free sum kinds don't), so the decision to
    reject is theirs (:func:`_stage_fmts`).
    """
    n_sites, j_n = len(segs), len(segs[0].in_regs)
    gather = np.full((n_sites, j_n), n_cols, np.int64)
    fmts: List[Optional[tuple]] = [None] * j_n
    pad_fmts: List[Optional[tuple]] = [None] * j_n
    for s, seg in enumerate(segs):
        if len(seg.in_regs) != j_n:
            raise _ComposeError("sites disagree on patch size")
        for j, r in enumerate(seg.in_regs):
            if r in colmap:
                gather[s, j] = colmap[r]
                fmt = _reg_fmt(prog, r)
                if fmts[j] is None:
                    fmts[j] = fmt
                elif fmts[j] != fmt:
                    fmts[j] = _MIXED_FMT
            else:
                ins = prog.instrs[r]
                if ins.op != "CONST" or ins.args[0] != 0:
                    raise _ComposeError(
                        f"input register r{r} is neither a previous-stage "
                        f"output nor a zero pad")
                pad_fmts[j] = _reg_fmt(prog, r)
    fmts = [f if f is not None else p for f, p in zip(fmts, pad_fmts)]
    return gather, fmts


def _stage_fmts(fmts) -> List[tuple]:
    """Uniform per-position formats, or a compose error for mixed ones."""
    for j, f in enumerate(fmts):
        if f == _MIXED_FMT:
            raise _ComposeError(
                f"position {j} has site-dependent register formats")
    return fmts


def _compose_lut_stage(prog: DaisProgram, segs, gather, fmts) -> FusedStage:
    """A "lut" layer: keep the shared LayerTables, requant + gather per site.

    The REQUANT → LLUT → align-CMUL chain of every cell is a pure function
    of one incoming code, evaluated at run time as shift-round → mask →
    table gather → align shift (the WRAP contract of
    ``core.tables.LayerTables``), so arbitrarily wide incoming registers
    never need enumerating and the table is exactly ``t.codes`` — stored
    once, indexed by all ``S`` sites.
    """
    t = prog.tables.get(segs[0].layer_id)
    if t is None:
        raise _ComposeError(f"layer {segs[0].layer_id} has no tables")
    ci, co = t.c_in, t.c_out
    if gather.shape[1] != ci or any(len(s.out_regs) != co for s in segs):
        raise _ComposeError("segment register counts don't match its tables")
    if int(np.asarray(t.codes).size) > _MAX_COMPOSED_ELEMS:
        raise _ComposeError(f"table too large ({t.codes.size} entries)")
    in_f = np.asarray([f for f, _w, _s in _stage_fmts(fmts)], np.int64)
    in_shift, mask, out_shift = t.gather_params(in_f)
    return FusedStage(
        kind="lut", gather=gather, n_cols=0,
        bias=np.zeros((len(segs), co), np.int64),
        in_shift=in_shift, mask=mask,
        table=np.asarray(t.codes, np.int64), out_shift=out_shift)


def _unary_chain(prog: DaisProgram, out_reg: int, symbols) -> Tuple[List[int], int]:
    """Longest REQUANT/CMUL/LLUT chain ending at ``out_reg``; returns the
    chain (outermost first) and the register it bottoms out on."""
    chain, r = [], out_reg
    while r not in symbols and prog.instrs[r].op in ("REQUANT", "CMUL", "LLUT"):
        chain.append(r)
        r = prog.instrs[r].args[0]
    return chain, r


def _collect_terms(prog: DaisProgram, root: int, symbols):
    """Decompose the ADD/SUB tree below ``root`` into univariate terms.

    Returns ``(terms, consts)``: each term is ``(j, sign, shift, chain)``
    — a unary instruction chain (innermost first) on symbol ``j``, shifted
    onto the root grid and signed; each const is ``(value, sign, shift,
    chain)``.  Raises :class:`_ComposeError` on anything else (the segment
    is then not a sum of univariate functions and cannot fuse).
    """
    terms, consts = [], []

    def walk(r, sign, shift, suffix):
        if r in symbols:
            terms.append((symbols[r], sign, shift, list(reversed(suffix))))
            return
        ins = prog.instrs[r]
        if ins.op == "CONST":
            consts.append((int(ins.args[0]), sign, shift, list(reversed(suffix))))
        elif ins.op in ("REQUANT", "CMUL", "LLUT"):
            walk(ins.args[0], sign, shift, suffix + [r])
        elif ins.op in ("ADD", "SUB"):
            if suffix:
                # a unary op below an ADD consumed by another unary chain is
                # fine; an ADD *inside* a unary suffix is not univariate
                raise _ComposeError("ADD nested inside a unary chain")
            ra, rb = ins.args
            fa, fb = prog.instrs[ra].reg.f, prog.instrs[rb].reg.f
            f = max(fa, fb)
            walk(ra, sign, shift + (f - fa), [])
            walk(rb, sign * (-1 if ins.op == "SUB" else 1),
                 shift + (f - fb), [])
        else:
            raise _ComposeError(f"op {ins.op} inside a segment body")

    ins = prog.instrs[root]
    if ins.op in ("ADD", "SUB"):
        ra, rb = ins.args
        fa, fb = prog.instrs[ra].reg.f, prog.instrs[rb].reg.f
        f = max(fa, fb)
        walk(ra, 1, f - fa, [])
        walk(rb, -1 if ins.op == "SUB" else 1, f - fb, [])
    else:
        walk(root, 1, 0, [])
    return terms, consts


def _eval_chain(prog: DaisProgram, chain: List[int], values: np.ndarray) -> np.ndarray:
    """Exactly evaluate a unary instruction chain on integer codes."""
    v = np.asarray(values, np.int64)
    for r in chain:
        ins = prog.instrs[r]
        if ins.op == "REQUANT":
            _src, f, i, signed, mode, src_f = ins.args
            v = _requant(v, src_f, f, i, signed, mode)
        elif ins.op == "CMUL":
            v = v * np.int64(ins.args[1])
        elif ins.op == "LLUT":
            _src, lid, j, i = ins.args
            t = prog.tables[lid]
            m = int(t.in_width[j, i])
            size = 1 << m if m > 0 else 1
            v = t.codes[j, i, np.mod(v, size)]
        else:  # unreachable: _unary_chain/_collect_terms only pass these ops
            raise _ComposeError(f"op {ins.op} in a unary chain")
    return v


def _chain_key(prog: DaisProgram, chain: List[int]) -> tuple:
    """Structural fingerprint of a unary chain (op + non-register args)."""
    return tuple((prog.instrs[r].op,) + tuple(prog.instrs[r].args[1:])
                 for r in chain)


def _decompose_site(prog: DaisProgram, seg):
    """Per-output structure of one site: (epilogue chain, terms, consts)."""
    symbols = {r: j for j, r in enumerate(seg.in_regs)}
    outs = []
    for out_reg in seg.out_regs:
        chain, r = _unary_chain(prog, out_reg, symbols)
        if r in symbols or prog.instrs[r].op == "CONST":
            # pure univariate chain (or folded constant): no epilogue, the
            # whole chain lives in the term/const
            terms, consts = _collect_terms(prog, out_reg, symbols)
            outs.append(([], terms, consts))
        elif prog.instrs[r].op in ("ADD", "SUB"):
            terms, consts = _collect_terms(prog, r, symbols)
            outs.append((list(reversed(chain)), terms, consts))
        else:
            raise _ComposeError(f"op {prog.instrs[r].op} at a segment output")
    return outs


def _epilogue_ops(prog: DaisProgram, per_site_epis, co: int) -> List[EpiOp]:
    """Vectorize per-(site, channel) epilogue chains into shared EpiOps.

    Every channel/site must agree on the op-name sequence; channels whose
    output folded to a constant/pure chain carry ``apply == 0`` and pass
    through untouched (a fake "identity" requant could clamp legal values
    of unsigned registers at the dtype width cap).
    """
    n_sites = len(per_site_epis)
    shapes = {tuple(prog.instrs[r].op for r in epi)
              for site in per_site_epis for epi in site if epi}
    if not shapes:
        return []
    if len(shapes) > 1:
        raise _ComposeError("outputs disagree on epilogue structure")
    ops = next(iter(shapes))
    out: List[EpiOp] = []
    for k, op in enumerate(ops):
        if op == "REQUANT":
            params = np.zeros((n_sites, co, 4), np.int64)
            params[..., 1] = 1            # harmless width for masked channels
            mode = None
            for s, site in enumerate(per_site_epis):
                for i, epi in enumerate(site):
                    if not epi:
                        continue
                    _src, f, ib, signed, m, src_f = prog.instrs[epi[k]].args
                    if mode is None:
                        mode = m
                    elif mode != m:
                        raise _ComposeError("mixed REQUANT modes in epilogue")
                    width = f + ib + (1 if signed else 0)
                    params[s, i] = (f - src_f, width, int(bool(signed)), 1)
            out.append(EpiOp(op="REQUANT", mode=mode or "SAT", params=params))
        elif op == "CMUL":
            params = np.ones((n_sites, co), np.int64)
            for s, site in enumerate(per_site_epis):
                for i, epi in enumerate(site):
                    if epi:
                        params[s, i] = int(prog.instrs[epi[k]].args[1])
            out.append(EpiOp(op="CMUL", mode="", params=params))
        else:
            raise _ComposeError(f"op {op} in an epilogue (not vectorizable)")
    return out


def _chain_only_site(prog: DaisProgram, site) -> Optional[List[int]]:
    """The single REQUANT/CMUL-only chain of a one-output site, or None.

    The shape a standalone relu lowers to: one unshifted positive bare-ish
    term whose unary chain can run *as the epilogue* on the gathered value
    itself — no enumeration, so the operand may be arbitrarily wide.
    """
    epi, terms, consts = site[0]
    if epi or consts or len(terms) != 1:
        return None
    _j, sign, shift, chain = terms[0]
    if (sign != 1 or shift != 0 or not chain
            or any(prog.instrs[r].op not in ("REQUANT", "CMUL")
                   for r in chain)):
        return None
    return chain


def _compose_enum_stage(prog: DaisProgram, segs, gather, fmts) -> FusedStage:
    """An "hgq"/"acc"/"relu" layer: decompose each output into a sum of
    univariate chains, then the cheapest faithful stage: table-free "sum"
    (every term a bare register — window accumulation), chain-as-epilogue
    (standalone relu), or each chain enumerated over its input register's
    code space into a site-shared table ("lut" semantics without
    LayerTables).
    """
    n_sites, j_n = gather.shape
    co = len(segs[0].out_regs)
    if any(len(s.out_regs) != co for s in segs):
        raise _ComposeError("sites disagree on output count")
    sites = [_decompose_site(prog, seg) for seg in segs]
    site0 = sites[0]

    # table-free chain-as-epilogue (standalone relu): per-site chains may
    # differ in params (per-channel grids) — only the op sequence must
    # agree, which _epilogue_ops enforces
    if co == 1 and j_n == 1:
        chains = [_chain_only_site(prog, site) for site in sites]
        if all(c is not None for c in chains):
            return FusedStage(
                kind="sum", gather=gather, n_cols=0,
                bias=np.zeros((n_sites, 1), np.int64),
                epilogue=_epilogue_ops(prog, [[c] for c in chains], co),
                shifts=np.zeros((n_sites, 1), np.int64),
                signs=np.ones((n_sites, 1), np.int64))

    # shared structure check: term chains must be identical across sites
    key0 = [[(j, sign, shift, _chain_key(prog, chain))
             for j, sign, shift, chain in terms]
            for _epi, terms, _consts in site0]
    for s, site in enumerate(sites[1:], start=1):
        key = [[(j, sign, shift, _chain_key(prog, chain))
                for j, sign, shift, chain in terms]
               for _epi, terms, _consts in site]
        if key != key0:
            raise _ComposeError(
                f"site {s} disagrees with site 0 on term structure")

    bias = np.zeros((n_sites, co), np.int64)
    for s, site in enumerate(sites):
        for i, (_epi, _terms, consts) in enumerate(site):
            for value, sign, shift, chain in consts:
                v = int(_eval_chain(prog, chain, np.asarray([value]))[0])
                bias[s, i] += sign * (v << shift)
    epilogue = _epilogue_ops(prog, [[epi for epi, _t, _c in site]
                                    for site in sites], co)

    all_terms = [t for _epi, terms, _c in site0 for t in terms]
    if co == 1 and all(not chain for _j, _sg, _sh, chain in all_terms):
        # table-free: window accumulation / plain aligned sums
        shifts = np.zeros((n_sites, j_n), np.int64)
        signs = np.zeros((n_sites, j_n), np.int64)
        for s, site in enumerate(sites):
            for _epi, terms, _c in site:
                for j, sign, shift, _chain in terms:
                    if signs[s, j]:
                        raise _ComposeError(
                            "register used twice in one table-free sum")
                    signs[s, j], shifts[s, j] = sign, shift
        return FusedStage(kind="sum", gather=gather, n_cols=0, bias=bias,
                          epilogue=epilogue, shifts=shifts, signs=signs)

    # enumerated tables: one (J, co, E) table shared by every site
    widths = [w for _f, w, _s in _stage_fmts(fmts)]
    if max(widths) > _MAX_ENUM_WIDTH:
        raise _ComposeError(
            f"operand register too wide to enumerate "
            f"({max(widths)} > {_MAX_ENUM_WIDTH} bits)")
    e_max = 1 << max(widths)
    if j_n * co * e_max > _MAX_COMPOSED_ELEMS:
        raise _ComposeError(
            f"composed table too large ({j_n * co * e_max} entries)")
    table = np.zeros((j_n, co, e_max), np.int64)
    mask = np.zeros((j_n, co), np.int64)
    codes = []
    for j, (_f, w, signed) in enumerate(fmts):
        e = np.arange(1 << w, dtype=np.int64)
        codes.append(np.where(e >= (1 << w) // 2, e - (1 << w), e)
                     if signed else e)
        mask[j, :] = (1 << w) - 1
    for i, (_epi, terms, _c) in enumerate(site0):
        for j, sign, shift, chain in terms:
            v = _eval_chain(prog, chain, codes[j])
            table[j, i, :len(v)] += sign * (v << shift)
    return FusedStage(kind="lut", gather=gather, n_cols=0, bias=bias,
                      epilogue=epilogue,
                      in_shift=np.zeros((j_n, co), np.int64), mask=mask,
                      table=table,
                      out_shift=np.zeros((j_n, co), np.int64))


def _shift_round_scalar(v: int, shift: int) -> int:
    """Python-int twin of :func:`_shift_round` (monotone in ``v``)."""
    if shift >= 0:
        return v << shift
    return _round_half_even(v, -shift)


def _stage_live(ranges, segs, stage: FusedStage) -> np.ndarray:
    """(J, co, E) bool mask of table entries any site can actually index.

    Per cell ``(j, i)`` the runtime index is
    ``shift_round(v) & mask[j, i]`` for ``v`` the site's incoming register
    value; with the proven ``[lo, hi]`` of that register and the shift
    being monotone, the reachable indices form a wrap-aware window
    (:func:`~repro_torch.core.analysis.index_window`).  Entries outside the
    union of all sites' windows — and entries past each cell's
    ``mask + 1`` grid size — are dead: typically the saturation rows that
    hold the largest-magnitude codes, which is exactly what keeps the
    packed lane dtype wide.
    """
    j_n, co, e_max = stage.table.shape
    live = np.zeros((j_n, co, e_max), bool)
    for seg in segs:
        for j, r in enumerate(seg.in_regs):
            lo, hi = ranges.range(r)
            for i in range(co):
                sh = int(stage.in_shift[j, i])
                size = int(stage.mask[j, i]) + 1
                win = index_window(_shift_round_scalar(lo, sh),
                                   _shift_round_scalar(hi, sh), size)
                live[j, i, :size] |= win
    return live


def compose_fused_stages(prog: DaisProgram, *,
                         ranges: Optional[object] = None,
                         ) -> Tuple[Optional[FusedStages], str]:
    """Compose a chain of per-site segments into per-layer fused stages.

    Returns ``(stages, "")`` on success, or ``(None, reason)`` when the
    program does not fit the fused pattern; callers surface ``reason``.

    ``ranges``: optional :class:`~repro_torch.core.analysis.ValueRanges` for
    ``prog`` — each "lut" stage then carries a ``live`` entry mask
    (:func:`_stage_live`) that the chain packer uses to narrow lanes.
    """
    if not prog.segments:
        return None, "program has no segment metadata"
    groups: List[list] = []
    for seg in prog.segments:
        if groups and groups[-1][0].layer_id == seg.layer_id:
            groups[-1].append(seg)
        else:
            groups.append([seg])
    colmap = {idx: int(ins.args[0]) for idx, ins in enumerate(prog.instrs)
              if ins.op == "IN"}
    n_cols = len(prog.input_f)
    stages: List[FusedStage] = []
    try:
        for segs in groups:
            kinds = {s.kind for s in segs}
            sites = sorted(s.site for s in segs)
            if len(kinds) != 1 or sites != list(range(len(segs))) or \
                    any(s.n_sites != len(segs) for s in segs):
                raise _ComposeError(
                    f"layer {segs[0].layer_id} has inconsistent site metadata")
            gather, fmts = _stage_gather(prog, segs, colmap, n_cols)
            if segs[0].kind == "lut":
                stage = _compose_lut_stage(prog, segs, gather, fmts)
            else:
                stage = _compose_enum_stage(prog, segs, gather, fmts)
            stage.n_cols = n_cols
            if ranges is not None and stage.table is not None:
                stage.live = _stage_live(ranges, segs, stage)
            stages.append(stage)
            colmap = {r: s * stage.c_out + i
                      for s, seg in enumerate(segs)
                      for i, r in enumerate(seg.out_regs)}
            n_cols = len(segs) * stage.c_out
        out_cols = np.asarray([colmap[r] for r in prog.outputs], np.int64)
    except _ComposeError as e:
        return None, str(e)
    except KeyError as e:
        return None, f"non-chain dataflow (register {e} skips a stage)"
    return FusedStages(stages=stages, out_cols=out_cols), ""


# ------------------------------------------------------------------ runner
def _prepare_stage(stage: FusedStage, dtype: torch.dtype, device):
    """Close one FusedStage over device constants -> (B, n_cols) -> (B, S*co)."""
    def dev(a):
        return _device_ints(a, dtype, device)

    gather = torch.as_tensor(np.asarray(stage.gather, np.int64), device=device)
    bias = dev(stage.bias)[None]                            # (1, S, co)
    epis = []
    for e in stage.epilogue:
        if e.op == "REQUANT":
            p = np.asarray(e.params, np.int64)
            epis.append((e.op, e.mode, dev(p[..., 0])[None], dev(p[..., 1])[None],
                         torch.as_tensor(p[..., 2] != 0, device=device)[None],
                         torch.as_tensor(p[..., 3] != 0, device=device)[None]))
        else:
            epis.append((e.op, "", dev(e.params)[None], None, None, None))

    if stage.kind == "lut":
        in_shift = dev(stage.in_shift)                      # (J, co)
        mask = dev(stage.mask)
        table = dev(stage.table)                            # (J, co, E)
        out_shift = dev(stage.out_shift)
        jj = torch.arange(table.shape[0], device=device)[:, None]
        ii = torch.arange(table.shape[1], device=device)[None, :]

        def body(g):                                        # g: (B, S, J)
            code = _shift_round(g[..., None], in_shift)     # (B, S, J, co)
            idx = (code & mask).long()
            vals = table[jj, ii, idx] << out_shift
            return vals.sum(dim=2, dtype=dtype)             # (B, S, co)
    else:
        shifts = dev(stage.shifts)[None]                    # (1, S, J)
        signs = dev(stage.signs)[None]

        def body(g):
            return (signs * (g << shifts)).sum(dim=-1, dtype=dtype)[..., None]

    def ex(v):
        b = v.shape[0]
        vz = torch.cat([v, torch.zeros((b, 1), dtype=v.dtype, device=v.device)], 1)
        acc = body(vz[:, gather]) + bias
        for op, mode, p0, p1, p2, apply in epis:
            if op == "REQUANT":
                acc = torch.where(apply, _requant_cols(acc, p0, p1, p2, mode), acc)
            else:
                acc = acc * p0
        return acc.reshape(b, -1)
    return ex


def _fused_runner(stages: FusedStages, dtype: torch.dtype, device):
    """Close a :class:`FusedStages` over device constants -> runner fn."""
    prepared = [_prepare_stage(st, dtype, device) for st in stages.stages]
    out_cols = torch.as_tensor(np.asarray(stages.out_cols, np.int64), device=device)

    def run(x):
        v = x
        for ex in prepared:
            v = ex(v)
        return v[:, out_cols]
    return run


# --------------------------------------------------------------------------- #
# single-layer engine: port of LayerTables.lookup_codes
# --------------------------------------------------------------------------- #
def lower_tables(t: LayerTables, x_f, x_width: int = 16, *,
                 device="cuda") -> Callable:
    """Batched gather evaluating one layer's truth tables on ``device``.

    Returns ``fn(x_codes) -> out_codes`` bit-exact against
    ``t.lookup_codes(x_codes, x_f)``: (B, C_in) codes on the ``x_f`` grid in,
    (B, C_out) codes on the ``t.common_f_out()`` grid out.  ``x_width`` is
    the physical width of the input codes (bounds the internal dtype).
    """
    ci, co = t.c_in, t.c_out
    device = torch.device(device)
    # (in_shift, mask, out_shift) incl. the pruned-cell out-shift clamp:
    # one derivation, shared with the fused stage composer
    shift, masks_np, out_shift_np = t.gather_params(x_f)    # (ci, co) each

    width_bound = max(
        int(x_width + max(shift.max(), 0)) + 1,
        int((np.maximum(t.out_width, 1) + out_shift_np).max())
        + int(np.ceil(np.log2(max(ci, 1)))) + 1)
    dtype = _pick_dtype(width_bound)

    def dev(arr):
        return _device_ints(arr, dtype, device)

    e = t.codes.shape[2]
    codes_d = dev(t.codes).reshape(-1)
    sh = dev(shift)[None]                                   # (1, ci, co)
    masks = dev(masks_np)[None]
    out_shift = dev(out_shift_np)[None]
    # (ci, co) offsets of each cell's row in the flattened (ci, co, E) table
    cell_off = torch.arange(ci * co, device=device,
                            dtype=torch.int64).reshape(ci, co) * e

    def fn(x_codes):
        v = torch.as_tensor(x_codes, device=device).to(dtype)[..., :, None]
        # integer round-half-to-even requant onto each cell's f_in grid
        code = _shift_round(v, sh)                          # (B, ci, co)
        idx = code & masks              # the WRAP contract (grids are 2**m)
        out = codes_d[idx.long() + cell_off]
        return (out << out_shift).sum(dim=-2, dtype=dtype)
    return fn


# --------------------------------------------------------------------------- #
# bit-exactness gate
# --------------------------------------------------------------------------- #
def input_code_bounds(prog: DaisProgram):
    """Per-input inclusive (lo, hi) integer code ranges of a program."""
    widths = [ins.reg.width for ins in prog.instrs if ins.op == "IN"]
    lo, hi = [], []
    for w, s in zip(widths, prog.input_signed):
        n = 1 << max(w, 1)
        lo.append(-(n >> 1) if s else 0)
        hi.append((lo[-1] + n - 1))
    return np.asarray(lo, np.int64), np.asarray(hi, np.int64)


def verify_engine(engine: ServeEngine, prog: DaisProgram, *,
                  n_random: int = 1024, seed: int = 0,
                  exhaustive_limit: int = 4096) -> Dict[str, int]:
    """Assert the engine matches ``DaisProgram.run`` bit-for-bit.

    Checks ``n_random`` uniform random input-code vectors, plus the full
    input cross-product whenever it has at most ``exhaustive_limit`` rows.
    Raises ``AssertionError`` on the first mismatch; returns the row counts
    checked so callers can log the gate.
    """
    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(seed)
    batches = [rng.integers(lo, hi + 1, (n_random, len(lo)), dtype=np.int64)]
    sizes = hi - lo + 1
    n_exhaustive = 0
    # log-domain size test: wide input spaces would overflow a plain product
    if np.sum(np.log2(sizes.astype(np.float64))) <= np.log2(exhaustive_limit):
        grid = np.indices(tuple(int(s) for s in sizes))
        batches.append(grid.reshape(len(lo), -1).T + lo[None, :])
        n_exhaustive = batches[-1].shape[0]
    for codes in batches:
        ref = prog.run(codes)
        got = engine.run(codes).cpu().numpy().astype(np.int64)
        np.testing.assert_array_equal(
            got, ref, err_msg="serving engine != DAIS interpreter")
    return {"random": n_random, "exhaustive": n_exhaustive,
            "max_width": prog.max_width(), "n_groups": engine.n_groups}
