"""Static analysis over DAIS programs: verifier, interval ranges, TV.

Port of ``repro.core.analysis`` (numpy only), three passes over the SSA
program:

1. :func:`verify_program` — structural verifier (use-before-def, the IN
   layout ABI, segment/site consistency, LLUT index widths vs table sizes,
   REQUANT parameter sanity), run after every lowering and after each
   ``core/opt.py`` rewrite.

2. :func:`analyze_ranges` — interval abstract interpretation: sound
   per-register ``[lo, hi]`` bounds (Python ints, so transients never wrap)
   through every op, including the transient pre-clamp/pre-mask values a
   fixed-dtype backend materializes.  ``engine_width()`` drives engine dtype
   selection in ``kernels/lut_serve.py`` and its per-register ranges give
   the ``live`` windows that narrow table lanes in
   ``kernels/lut_serve_cuda.py``.

3. :func:`validate_rewrite` — translation validation for ``core/opt.py``.
   ``eliminate_dead_cells`` emits a :class:`RewriteObligations` record of
   every claim it made (folded constants, aliases, shift rewrites, the
   register renumbering, sliced-row provenance); the checker re-derives
   each claim from the *before* program's semantics and structurally
   matches the *after* program against the mapping.

``launch/lint.py`` is the CLI over all three.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NoReturn, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dais import OP_DEPS, DaisProgram, Instr

__all__ = [
    "AnalysisError", "Diagnostic", "RewriteObligations", "ValueRanges",
    "VerifyError", "analyze_ranges", "index_window", "validate_rewrite",
    "verify_program",
]

# Exact arity of each op's args tuple (OP_DEPS only names the *register*
# positions; the verifier needs the full shape).
_N_ARGS: Dict[str, int] = {
    "IN": 1, "CONST": 1, "REQUANT": 6, "LLUT": 4, "CMUL": 3,
    "ADD": 2, "SUB": 2,
}
_MODES = ("SAT", "WRAP")


class AnalysisError(ValueError):
    """The interval analysis could not produce a sound result."""


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding, anchored to a program location."""

    where: str            # "instr 12" | "segment 3" | "outputs" | "inputs"
    message: str

    def __str__(self) -> str:
        return f"{self.where}: {self.message}"


class VerifyError(ValueError):
    """Structural verification failed; ``diagnostics`` has every finding."""

    def __init__(self, diagnostics: Sequence[Diagnostic]) -> None:
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        shown = "\n".join(f"  - {d}" for d in self.diagnostics[:20])
        extra = len(self.diagnostics) - 20
        if extra > 0:
            shown += f"\n  ... and {extra} more"
        super().__init__(
            f"DAIS program failed structural verification "
            f"({len(self.diagnostics)} error(s)):\n{shown}")


# --------------------------------------------------------------------------- #
# shared fixed-point helpers (Python-int exact, mirroring core/dais._requant)
# --------------------------------------------------------------------------- #
def _sbits(x: int) -> int:
    """Bits (incl. sign) of a signed representation holding ``x``."""
    return x.bit_length() + 1 if x >= 0 else (-x - 1).bit_length() + 1


def _range_width(lo: int, hi: int) -> int:
    """Physical bits needed for every value in ``[lo, hi]``.

    Each side is measured under its own convention — negatives as signed
    (incl. sign bit), non-negatives as unsigned value bits — mirroring how
    ``Reg.width`` counts bits (``f+i+1`` signed, ``f+i`` unsigned) and how
    the engine dtype cliff interprets the bound (width ``w <= 30`` fits
    int32 either way).  A register declared ``width=w`` holding its full
    range maps back to exactly ``w``, which keeps ``proven_width()`` below
    ``required_width()`` structurally, not just empirically; measuring a
    mixed-sign hull as one signed interval would overcount the positive
    side by a bit (a signed-source/unsigned-WRAP requant transient would
    then "prove" more bits than the structural bound).
    """
    if lo >= 0:
        return hi.bit_length()
    return max(_sbits(lo), hi.bit_length() if hi >= 0 else _sbits(hi))


def _declared_bounds(width: int, signed: bool) -> Tuple[int, int]:
    """Value bounds of a declared register format.

    Matches the ``input_code_bounds`` convention (``n = 1 << max(w, 1)``):
    the supported input contract, and the grid the verifier holds CONSTs
    and table entries to.
    """
    n = 1 << max(int(width), 1)
    lo = -(n >> 1) if signed else 0
    return lo, lo + n - 1


def _round_half_even(v: int, s: int) -> int:
    """``v * 2**-s`` with round-half-to-even (``s > 0``), exactly as
    ``core.dais._requant`` computes it (Python ``>>`` floors like int64)."""
    floor = v >> s
    rem = v - (floor << s)
    half = 1 << (s - 1)
    if rem > half:
        return floor + 1
    if rem < half:
        return floor
    return floor + (floor & 1)


def requant_scalar(v: int, src_f: int, f: int, i: int, signed: bool,
                   mode: str) -> int:
    """Exact scalar REQUANT (the Python-int twin of ``dais._requant``)."""
    shift = f - src_f
    code = v << shift if shift >= 0 else _round_half_even(v, -shift)
    width = f + i + (1 if signed else 0)
    if width <= 0:
        return 0
    n = 1 << width
    lo = -(n >> 1) if signed else 0
    hi = lo + n - 1
    if mode == "SAT":
        return min(max(code, lo), hi)
    return lo + ((code - lo) % n)




def index_window(lo: int, hi: int, size: int) -> np.ndarray:
    """Boolean mask of the table indices ``v % size`` can reach for
    ``v in [lo, hi]`` — the wrap-aware window both the LLUT transfer
    function and the packed-chain lane narrower use."""
    mask = np.zeros(size, bool)
    if hi - lo + 1 >= size:
        mask[:] = True
        return mask
    a, b = lo % size, hi % size
    if a <= b:
        mask[a:b + 1] = True
    else:
        mask[a:] = True
        mask[:b + 1] = True
    return mask


def _llut_slice(prog: DaisProgram, ins: Instr) -> Tuple[np.ndarray, int]:
    """Addressable slice of the truth-table row an LLUT reads."""
    _src, lid, j, i = ins.args
    t = prog.tables[lid]
    m = int(t.in_width[j, i])
    size = (1 << m) if m > 0 else 1
    return np.asarray(t.codes[j, i, :size], np.int64), size


# --------------------------------------------------------------------------- #
# pass 1: structural verifier
# --------------------------------------------------------------------------- #
def verify_program(prog: DaisProgram, *,
                   raise_on_error: bool = True) -> List[Diagnostic]:
    """Check every structural invariant a well-formed program satisfies.

    Returns the list of diagnostics (empty = verified); with
    ``raise_on_error`` (the default) a non-empty list raises
    :class:`VerifyError` instead.  The invariants are exactly the ones
    ``docs/ir.md`` specifies — notably they do NOT require a REQUANT's
    declared register width to cover its clamp grid (the relu lowering
    legitimately declares narrower), only value-level consistency.
    """
    diags: List[Diagnostic] = []
    n = len(prog.instrs)

    def err(where: str, message: str) -> None:
        diags.append(Diagnostic(where, message))

    if len(prog.input_f) != len(prog.input_signed):
        err("inputs", f"input_f has {len(prog.input_f)} entries but "
                      f"input_signed has {len(prog.input_signed)}")
    n_inputs = len(prog.input_f)

    in_ks: List[int] = []
    for idx, ins in enumerate(prog.instrs):
        where = f"instr {idx}"
        if ins.op not in OP_DEPS:
            err(where, f"unknown op {ins.op!r}")
            continue
        if len(ins.args) != _N_ARGS[ins.op]:
            err(where, f"{ins.op} expects {_N_ARGS[ins.op]} args, "
                       f"got {len(ins.args)}")
            continue
        if not (0 <= ins.reg.width <= 64):
            err(where, f"register width {ins.reg.width} outside [0, 64]")
        # use-before-def / dangling references (SSA is a linear order)
        bad_ref = False
        for p in OP_DEPS[ins.op]:
            r = ins.args[p]
            if not isinstance(r, (int, np.integer)) or not 0 <= r < idx:
                err(where, f"{ins.op} arg {p} references register {r!r} "
                           f"(must be an earlier index in [0, {idx}))")
                bad_ref = True
        if bad_ref:
            continue

        if ins.op == "IN":
            k = ins.args[0]
            if not 0 <= k < n_inputs:
                err(where, f"IN reads input {k} but the program declares "
                           f"{n_inputs} inputs")
            else:
                in_ks.append(int(k))
                if ins.reg.f != prog.input_f[k]:
                    err(where, f"IN {k} declares f={ins.reg.f} but "
                               f"input_f[{k}]={prog.input_f[k]}")
                if bool(ins.reg.signed) != bool(prog.input_signed[k]):
                    err(where, f"IN {k} signedness {ins.reg.signed} != "
                               f"input_signed[{k}]={prog.input_signed[k]}")
        elif ins.op == "CONST":
            lo, hi = _declared_bounds(ins.reg.width, ins.reg.signed)
            c = int(ins.args[0])
            if not lo <= c <= hi:
                err(where, f"CONST {c} outside its declared "
                           f"{ins.reg.width}-bit "
                           f"{'signed' if ins.reg.signed else 'unsigned'} "
                           f"range [{lo}, {hi}]")
        elif ins.op == "REQUANT":
            _src, f, _i, _signed, mode, src_f = ins.args
            if mode not in _MODES:
                err(where, f"REQUANT mode {mode!r} not in {_MODES}")
            if src_f != prog.instrs[ins.args[0]].reg.f:
                err(where, f"REQUANT records src_f={src_f} but its source "
                           f"register is on grid "
                           f"f={prog.instrs[ins.args[0]].reg.f}")
            if ins.reg.f != f:
                err(where, f"REQUANT targets grid f={f} but declares "
                           f"register f={ins.reg.f}")
        elif ins.op == "LLUT":
            _src, lid, j, i = ins.args
            if lid not in prog.tables:
                err(where, f"LLUT references missing table set {lid}")
                continue
            t = prog.tables[lid]
            if not (0 <= j < t.c_in and 0 <= i < t.c_out):
                err(where, f"LLUT cell ({j}, {i}) outside table {lid}'s "
                           f"({t.c_in}, {t.c_out}) grid")
                continue
            m = int(t.in_width[j, i])
            size = (1 << m) if m > 0 else 1
            if m < 0 or size > t.codes.shape[2]:
                err(where, f"LLUT cell ({j}, {i}) index width {m} "
                           f"addresses {size} entries but table {lid} "
                           f"stores {t.codes.shape[2]}")
                continue
            if ins.reg.f != int(t.f_out[j, i]):
                err(where, f"LLUT declares f={ins.reg.f} but table cell "
                           f"({j}, {i}) outputs grid f={int(t.f_out[j, i])}")
            row = np.asarray(t.codes[j, i, :size], np.int64)
            lo, hi = _declared_bounds(ins.reg.width, ins.reg.signed)
            if row.size and not (lo <= int(row.min())
                                 and int(row.max()) <= hi):
                err(where, f"table {lid} cell ({j}, {i}) entries span "
                           f"[{int(row.min())}, {int(row.max())}], outside "
                           f"the declared {ins.reg.width}-bit register "
                           f"range [{lo}, {hi}]")
        elif ins.op in ("ADD", "SUB"):
            ra, rb = ins.args
            F = max(prog.instrs[ra].reg.f, prog.instrs[rb].reg.f)
            if ins.reg.f != F:
                err(where, f"{ins.op} computes on the aligned grid f={F} "
                           f"but declares f={ins.reg.f}")

    # IN layout is ABI: engines recover the input vector by walking IN
    # instructions in order, so they must be exactly 0..n_inputs-1, once
    # each, ascending.
    if in_ks != list(range(n_inputs)):
        err("inputs", f"IN instructions read {in_ks} — expected exactly "
                      f"one IN per input, ascending 0..{n_inputs - 1}")

    if len(prog.outputs) != len(prog.output_f):
        err("outputs", f"{len(prog.outputs)} outputs but "
                       f"{len(prog.output_f)} output_f entries")
    for k, r in enumerate(prog.outputs):
        if not 0 <= r < n:
            err("outputs", f"output {k} references register {r} "
                           f"(program has {n})")
        elif k < len(prog.output_f) and prog.instrs[r].reg.f != prog.output_f[k]:
            err("outputs", f"output {k} register {r} is on grid "
                           f"f={prog.instrs[r].reg.f} but output_f[{k}]="
                           f"{prog.output_f[k]}")

    for s_idx, seg in enumerate(prog.segments):
        where = f"segment {s_idx}"
        for r in (*seg.in_regs, *seg.out_regs):
            if not 0 <= r < n:
                err(where, f"references register {r} (program has {n})")
        if not 0 <= seg.site < seg.n_sites:
            err(where, f"site {seg.site} outside n_sites={seg.n_sites}")
        if seg.kind == "lut":
            if seg.layer_id not in prog.tables:
                err(where, f"lut segment references missing table set "
                           f"{seg.layer_id}")
            else:
                t = prog.tables[seg.layer_id]
                if len(seg.in_regs) != t.c_in:
                    err(where, f"lut segment has {len(seg.in_regs)} in_regs "
                               f"but table {seg.layer_id} has c_in={t.c_in}")
                if len(seg.out_regs) != t.c_out:
                    err(where, f"lut segment has {len(seg.out_regs)} "
                               f"out_regs but table {seg.layer_id} has "
                               f"c_out={t.c_out}")

    if diags and raise_on_error:
        raise VerifyError(diags)
    return diags


# --------------------------------------------------------------------------- #
# pass 2: interval abstract interpretation
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ValueRanges:
    """Per-register sound value intervals (and transients) of one program.

    ``lo[r] <= v <= hi[r]`` for every value register ``r`` can hold under
    the supported input contract (in-range codes per the declared input
    widths, the same contract ``input_code_bounds`` encodes).
    ``transient_lo/hi`` additionally cover the pre-clamp / pre-mask /
    shifted-operand values a backend materializes while computing ``r``.
    All Python ints: transients wider than 64 bits stay exact.
    """

    lo: List[int]
    hi: List[int]
    transient_lo: List[int]
    transient_hi: List[int]
    required: int                 # DaisProgram.required_width() at analysis
    _engine: int = 0

    def range(self, r: int) -> Tuple[int, int]:
        return self.lo[r], self.hi[r]

    def width(self, r: int) -> int:
        """Proven physical bits of register ``r`` (value only)."""
        return _range_width(self.lo[r], self.hi[r])

    def transient_width(self, r: int) -> int:
        return max(self.width(r),
                   _range_width(self.transient_lo[r], self.transient_hi[r]))

    def proven_width(self) -> int:
        """Program-level proven bound: max over registers AND transients.

        Always ``<= required_width()`` on verified programs —
        :func:`analyze_ranges` raises :class:`AnalysisError` otherwise
        (a violation would mean the analysis is unsound, not the program).
        """
        return max((self.transient_width(r) for r in range(len(self.lo))),
                   default=0)

    def engine_width(self) -> int:
        """Dtype-selection bound: proven values PLUS the structural
        constants a backend materializes (clamp grids, shift factors,
        CMUL codes, full table rows).  This is the bound
        ``compile_program`` sizes its dtype from; it may exceed
        ``proven_width()`` but never what the engine actually needs."""
        return self._engine


def analyze_ranges(prog: DaisProgram,
                   input_bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                   ) -> ValueRanges:
    """Forward interval analysis over the SSA list.

    ``input_bounds`` optionally overrides the per-input code bounds
    (defaults to the declared IN widths, the ``input_code_bounds``
    contract).  Raises :class:`AnalysisError` if the proven bound ever
    exceeds ``required_width()`` — that invariant is property-tested and
    load-bearing for engine dtype selection.
    """
    lo: List[int] = []
    hi: List[int] = []
    tlo: List[int] = []
    thi: List[int] = []

    for idx, ins in enumerate(prog.instrs):
        op, a = ins.op, ins.args
        if op == "IN":
            k = int(a[0])
            if input_bounds is not None:
                rlo, rhi = int(input_bounds[0][k]), int(input_bounds[1][k])
            else:
                rlo, rhi = _declared_bounds(ins.reg.width, ins.reg.signed)
            xlo, xhi = rlo, rhi
        elif op == "CONST":
            rlo = rhi = xlo = xhi = int(a[0])
        elif op == "REQUANT":
            src, f, i, signed, mode, src_f = a
            (rlo, rhi), (xlo, xhi) = _requant_range(
                lo[src], hi[src], int(src_f), int(f), int(i), bool(signed),
                mode)
        elif op == "LLUT":
            src = a[0]
            row, size = _llut_slice(prog, ins)
            win = index_window(lo[src], hi[src], size)
            live = row[win]
            rlo, rhi = int(live.min()), int(live.max())
            xlo, xhi = rlo, rhi
        elif op == "CMUL":
            src, code = int(a[0]), int(a[1])
            if code >= 0:
                rlo, rhi = lo[src] * code, hi[src] * code
            else:
                rlo, rhi = hi[src] * code, lo[src] * code
            xlo, xhi = rlo, rhi
        else:  # ADD / SUB
            ra, rb = a
            fa, fb = prog.instrs[ra].reg.f, prog.instrs[rb].reg.f
            F = max(fa, fb)
            alo, ahi = lo[ra] << (F - fa), hi[ra] << (F - fa)
            blo, bhi = lo[rb] << (F - fb), hi[rb] << (F - fb)
            if op == "ADD":
                rlo, rhi = alo + blo, ahi + bhi
            else:
                rlo, rhi = alo - bhi, ahi - blo
            xlo, xhi = min(alo, blo, rlo), max(ahi, bhi, rhi)
        lo.append(rlo)
        hi.append(rhi)
        tlo.append(min(xlo, rlo))
        thi.append(max(xhi, rhi))

    ranges = ValueRanges(lo=lo, hi=hi, transient_lo=tlo, transient_hi=thi,
                         required=prog.required_width())
    proven = ranges.proven_width()
    if proven > ranges.required:
        raise AnalysisError(
            f"interval analysis proved {proven} bits but required_width() "
            f"is {ranges.required} — unsound transfer function or "
            f"unverified program (run verify_program first)")
    ranges._engine = _engine_bound(prog, ranges, proven)
    return ranges


def _requant_range(lo: int, hi: int, src_f: int, f: int, i: int,
                   signed: bool, mode: str,
                   ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Interval transfer of REQUANT; returns ((lo, hi), (pre-clamp lo, hi)).

    The rounding stage is monotone non-decreasing, so rounding the interval
    endpoints is exact.  WRAP is only interval-friendly when the rounded
    range fits one period of the grid; otherwise the result widens to the
    full grid.
    """
    shift = f - src_f
    if shift >= 0:
        plo, phi = lo << shift, hi << shift
    else:
        plo, phi = _round_half_even(lo, -shift), _round_half_even(hi, -shift)
    width = f + i + (1 if signed else 0)
    if width <= 0:
        return (0, 0), (plo, phi)
    n = 1 << width
    glo = -(n >> 1) if signed else 0
    ghi = glo + n - 1
    if mode == "SAT":
        return (min(max(plo, glo), ghi), min(max(phi, glo), ghi)), (plo, phi)
    # WRAP
    if phi - plo + 1 >= n:
        return (glo, ghi), (plo, phi)
    a = glo + ((plo - glo) % n)
    b = glo + ((phi - glo) % n)
    if a <= b:
        return (a, b), (plo, phi)
    return (glo, ghi), (plo, phi)


def _engine_bound(prog: DaisProgram, ranges: ValueRanges, proven: int) -> int:
    """Width bound for a fixed-dtype backend: proven values plus every
    structural constant the engine lowers into its arithmetic."""
    eng = proven
    row_range: Dict[int, Tuple[int, int]] = {}   # LLUT idx -> full-slice span
    for idx, ins in enumerate(prog.instrs):
        op, a = ins.op, ins.args
        if op == "REQUANT":
            _src, f, i, signed, _mode, src_f = a
            grid = int(f) + int(i) + (1 if signed else 0)
            if grid > 0:
                eng = max(eng, grid)
            eng = max(eng, abs(int(f) - int(src_f)) + 1)
        elif op == "LLUT":
            row, _size = _llut_slice(prog, ins)
            span = (int(row.min()), int(row.max())) if row.size else (0, 0)
            row_range[idx] = span
            m = int(prog.tables[a[1]].in_width[a[2], a[3]])
            eng = max(eng, m, _range_width(*span))
        elif op == "CMUL":
            src, code = int(a[0]), int(a[1])
            eng = max(eng, _range_width(min(code, 0), max(code, 0)))
            if src in row_range:
                # packed/fused tables fold this multiply into EVERY stored
                # entry, live or not — the full row must fit post-multiply
                rl, rh = row_range[src]
                prods = (rl * code, rh * code)
                eng = max(eng, _range_width(min(prods), max(prods)) + 1)
        elif op in ("ADD", "SUB"):
            ra, rb = a
            fa, fb = prog.instrs[ra].reg.f, prog.instrs[rb].reg.f
            F = max(fa, fb)
            eng = max(eng, (F - fa) + 1, (F - fb) + 1)
            for r, s in ((ra, F - fa), (rb, F - fb)):
                if r in row_range:
                    rl, rh = row_range[r]
                    eng = max(eng, _range_width(rl << s, rh << s) + 1)
    # the enumerated HGQ composition tabulates its chains over the
    # DECLARED input widths (not the proven ranges), so those programs
    # keep the conservative bound
    if any(seg.kind == "hgq" for seg in prog.segments):
        eng = max(eng, ranges.required)
    return eng


# --------------------------------------------------------------------------- #
# pass 3: translation validation for core/opt.py
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class RewriteObligations:
    """Everything ``eliminate_dead_cells`` claims about its rewrite.

    ``const`` maps before-indices to the folded value; ``alias`` to the
    before-index they were collapsed onto; ``shift_rw`` to the
    ``(before target, signed power-of-two code)`` CMUL rewrite; ``new_of``
    is the surviving-instruction renumbering; ``keep_rows`` / ``row_map``
    record the shared-table slicing per layer id.  All indices refer to
    the *before* program except ``new_of``'s values.
    """

    const: Dict[int, int]
    alias: Dict[int, int]
    shift_rw: Dict[int, Tuple[int, int]]
    new_of: Dict[int, int]
    keep_rows: Dict[int, np.ndarray]
    row_map: Dict[int, Dict[int, int]]


def validate_rewrite(before: DaisProgram, after: DaisProgram,
                     ob: RewriteObligations) -> None:
    """Statically discharge a DCE rewrite's obligations.

    Raises :class:`AnalysisError` (or :class:`VerifyError` for structural
    breakage in ``after``) if any claim fails; returns ``None`` when the
    rewrite is proven.  The checks are independent re-derivations — the
    optimizer's own analysis functions are deliberately not reused.
    """
    verify_program(after)

    def fail(msg: str) -> NoReturn:
        raise AnalysisError(f"translation validation failed: {msg}")

    if (list(before.input_f) != list(after.input_f)
            or list(map(bool, before.input_signed)) != list(
                map(bool, after.input_signed))
            or list(before.output_f) != list(after.output_f)
            or len(before.outputs) != len(after.outputs)):
        fail("rewrite changed the program ABI (input/output grids)")

    def resolve(r: int) -> int:
        seen = set()
        while r in ob.alias:
            if r in seen:
                fail(f"alias cycle through register {r}")
            seen.add(r)
            r = ob.alias[r]
        return r

    # --- constant claims: re-derive each from the before-program semantics
    for idx, c in ob.const.items():
        ins = before.instrs[idx]
        op, a = ins.op, ins.args
        ok = False
        if op == "CONST":
            ok = int(a[0]) == c
        elif op == "LLUT":
            row, size = _llut_slice(before, ins)
            src_c = ob.const.get(a[0])
            if src_c is not None:
                ok = int(row[src_c % size]) == c
            else:
                ok = bool(row.size) and bool(np.all(row == c))
        elif op == "REQUANT":
            src, f, i, signed, mode, src_f = a
            if int(f) + int(i) + (1 if signed else 0) <= 0:
                ok = c == 0
            elif ob.const.get(src) is not None:
                ok = requant_scalar(ob.const[src], int(src_f), int(f),
                                    int(i), bool(signed), mode) == c
        elif op == "CMUL":
            src, code = a[0], int(a[1])
            if code == 0:
                ok = c == 0
            elif ob.const.get(src) is not None:
                ok = ob.const[src] * code == c
        elif op in ("ADD", "SUB"):
            ca, cb = ob.const.get(a[0]), ob.const.get(a[1])
            if ca is not None and cb is not None:
                fa = before.instrs[a[0]].reg.f
                fb = before.instrs[a[1]].reg.f
                F = max(fa, fb)
                va, vb = ca << (F - fa), cb << (F - fb)
                ok = (va + vb if op == "ADD" else va - vb) == c
        if not ok:
            fail(f"constant claim const[{idx}]={c} is not justified by "
                 f"{op} semantics")

    # --- alias / shift-rewrite claims: x ± 0 collapses only -------------- #
    for idx, target in ob.alias.items():
        ins = before.instrs[idx]
        if ins.op not in ("ADD", "SUB"):
            fail(f"alias[{idx}] on a non-ADD/SUB op {ins.op}")
        ra, rb = ins.args
        fa, fb = before.instrs[ra].reg.f, before.instrs[rb].reg.f
        F = max(fa, fb)
        if ob.const.get(rb) == 0 and resolve(ra) == resolve(target):
            shift, src = F - fa, ra
        elif (ob.const.get(ra) == 0 and ins.op == "ADD"
              and resolve(rb) == resolve(target)):
            shift, src = F - fb, rb
        else:
            fail(f"alias[{idx}] -> {target}: neither operand is a proven "
                 f"zero feeding that target")
        if shift != 0:
            fail(f"alias[{idx}] -> {target} drops a 2**{shift} alignment")
        if before.instrs[src].reg.f != ins.reg.f:
            fail(f"alias[{idx}] -> {target} changes the value grid "
                 f"(f={before.instrs[src].reg.f} vs f={ins.reg.f})")

    for idx, (target, code) in ob.shift_rw.items():
        ins = before.instrs[idx]
        if ins.op not in ("ADD", "SUB"):
            fail(f"shift_rw[{idx}] on a non-ADD/SUB op {ins.op}")
        ra, rb = ins.args
        fa, fb = before.instrs[ra].reg.f, before.instrs[rb].reg.f
        F = max(fa, fb)
        if ob.const.get(rb) == 0 and resolve(ra) == resolve(target):
            want = 1 << (F - fa)
        elif ob.const.get(ra) == 0 and resolve(rb) == resolve(target):
            want = (1 << (F - fb)) if ins.op == "ADD" else -(1 << (F - fb))
        else:
            fail(f"shift_rw[{idx}] -> {target}: neither operand is a "
                 f"proven zero feeding that target")
        if code != want:
            fail(f"shift_rw[{idx}] claims code {code}, semantics give {want}")

    # --- sliced tables: kept rows identical, dropped rows provably inert - #
    if set(before.tables) != set(after.tables):
        fail("rewrite added or removed table sets")
    for lid, t0 in before.tables.items():
        keep = np.asarray(ob.keep_rows.get(lid, np.ones(t0.c_in, bool)), bool)
        t1 = after.tables[lid]
        if keep.shape != (t0.c_in,) or int(keep.sum()) != t1.c_in:
            fail(f"table {lid}: keep mask shape/count does not match the "
                 f"sliced table")
        kept = np.where(keep)[0]
        if ob.row_map.get(lid, {}) != {int(j): k
                                       for k, j in enumerate(kept)}:
            fail(f"table {lid}: row_map is not the order-preserving "
                 f"renumbering of the keep mask")
        for fld in ("f_in", "i_in", "f_out", "i_out", "in_width",
                    "out_width", "codes"):
            if not np.array_equal(np.asarray(getattr(t0, fld))[keep],
                                  np.asarray(getattr(t1, fld))):
                fail(f"table {lid}: kept rows' {fld} changed")
        for j in np.where(~keep)[0]:
            if np.any(t0.codes[j]):
                fail(f"table {lid}: dropped row {j} has nonzero codes — "
                     f"its contribution is not provably zero")

    # --- instruction mapping: structural correspondence ------------------ #
    def mapped(r: int) -> int:
        r = resolve(r)
        if r not in ob.new_of:
            fail(f"before-register {r} is live through the mapping but "
                 f"has no new_of entry")
        return ob.new_of[r]

    for idx, nidx in ob.new_of.items():
        if not 0 <= nidx < len(after.instrs):
            fail(f"new_of[{idx}]={nidx} outside the after program")
        ins0, ins1 = before.instrs[idx], after.instrs[nidx]
        r0, r1 = ins0.reg, ins1.reg
        if idx in ob.const and ins0.op != "CONST":
            if (ins1.op != "CONST" or int(ins1.args[0]) != ob.const[idx]
                    or r1.f != r0.f or bool(r1.signed) != bool(r0.signed)
                    or r1.width != max(r0.width, 1)):
                fail(f"folded const {idx} -> {nidx} does not materialize "
                     f"CONST {ob.const[idx]} in the original format")
            continue
        if idx in ob.shift_rw:
            target, code = ob.shift_rw[idx]
            if (ins1.op != "CMUL" or int(ins1.args[1]) != code
                    or ins1.args[0] != mapped(target)
                    or (r1.f, r1.width, r1.signed) != (r0.f, r0.width,
                                                       r0.signed)):
                fail(f"shift rewrite {idx} -> {nidx} does not materialize "
                     f"CMUL {code} of the mapped target")
            continue
        if ins1.op != ins0.op:
            fail(f"mapped instr {idx} -> {nidx} changed op "
                 f"{ins0.op} -> {ins1.op}")
        if (r1.f, r1.width, bool(r1.signed)) != (r0.f, r0.width,
                                                 bool(r0.signed)):
            fail(f"mapped instr {idx} -> {nidx} changed register format")
        args0 = list(ins0.args)
        args1 = list(ins1.args)
        for p in OP_DEPS[ins0.op]:
            if args1[p] != mapped(args0[p]):
                fail(f"mapped instr {idx} -> {nidx}: arg {p} does not "
                     f"follow the renumbering")
            args0[p] = args1[p]
        if ins0.op == "LLUT":
            lid, j = args0[1], int(ins0.args[2])
            rm = ob.row_map.get(lid, {})
            if j not in rm:
                fail(f"live LLUT {idx} reads dropped row {j} of table {lid}")
            args0[2] = rm[j]
        if tuple(args0) != tuple(args1):
            fail(f"mapped instr {idx} -> {nidx}: non-register args changed "
                 f"({tuple(ins0.args)} vs {tuple(ins1.args)})")

    # --- outputs and segments follow the mapping -------------------------- #
    for k, r in enumerate(before.outputs):
        if after.outputs[k] != mapped(r):
            fail(f"output {k} does not follow the register mapping")

    if len(before.segments) != len(after.segments):
        fail("rewrite changed the segment count")
    for s_idx, (s0, s1) in enumerate(zip(before.segments, after.segments)):
        if (s0.kind, s0.layer_id, s0.site, s0.n_sites) != (
                s1.kind, s1.layer_id, s1.site, s1.n_sites):
            fail(f"segment {s_idx} metadata changed")
        in_regs = s0.in_regs
        if s0.kind == "lut" and s0.layer_id in ob.keep_rows:
            keep = ob.keep_rows[s0.layer_id]
            in_regs = tuple(r for j, r in enumerate(in_regs)
                            if j < len(keep) and keep[j])
        for label, regs0, regs1 in (("in", in_regs, s1.in_regs),
                                    ("out", s0.out_regs, s1.out_regs)):
            if len(regs0) != len(regs1):
                fail(f"segment {s_idx} {label}_regs length changed")
            for r0, r1 in zip(regs0, regs1):
                rr = resolve(r0)
                if rr in ob.new_of:
                    if r1 != ob.new_of[rr]:
                        fail(f"segment {s_idx} {label}_reg {r0} does not "
                             f"follow the register mapping")
                    continue
                # dead register: the stand-in must be a CONST 0 in the
                # dead register's full declared format
                reg0 = before.instrs[rr].reg
                ins1 = after.instrs[r1]
                if (ins1.op != "CONST" or int(ins1.args[0]) != 0
                        or ins1.reg.f != reg0.f
                        or ins1.reg.width != max(reg0.width, 1)
                        or bool(ins1.reg.signed) != bool(reg0.signed)):
                    fail(f"segment {s_idx} {label}_reg {r0} died but its "
                         f"stand-in is not a format-preserving CONST 0")
