"""Dead-cell elimination (DCE) over DAIS programs, port of ``repro.core.opt``
(numpy only).

Training with β·EBOPs prunes L-LUT cells at *fake-quant* time: a cell whose
bit-widths reach zero contributes exactly 0 to the layer output.  The
lowering (``core/lower.py``) already skips width-pruned cells, but the
pruning never reached the rest of the hardware side:

* cells whose truth table is **constant** (most commonly all-zero — the SAT
  output quantizer collapses just before the width hits 0) still emit a
  full REQUANT → LLUT → align chain per spatial site,
* their input channels still occupy fused-stage **gather slots**
  (``kernels/lut_serve.py``) and case **functions** in the emitted Verilog
  (``core/rtl.py``),
* the interpreter still dispatches every one of those dead instructions.

:func:`eliminate_dead_cells` closes the loop.  It rewrites a program into a
bit-exact smaller one:

1. **constant-LLUT folding** — an LLUT whose addressable table row is a
   single value (1-entry pruned cells, constant-0 output cells) becomes
   that constant; so does any LLUT fed by a constant index;
2. **constant propagation** through REQUANT / CMUL / ADD / SUB chains
   (``x + 0`` collapses to an alignment shift or a plain alias);
3. **dead-register compaction** — instructions unreachable from the
   program outputs are dropped and the SSA indices renumbered;
4. **table-row shrinking** — input rows of a shared :class:`LayerTables`
   that end up with no live lookup *and* an all-zero contribution are
   sliced out of the stored tables and out of every site's
   ``Segment.in_regs``, which is what shrinks the fused engine's per-site
   gather width.

Segment metadata stays structurally valid throughout (every referenced
register exists in the optimized program), so the optimized program still
qualifies for the fused per-layer engine lowering and for RTL emission.
Bit-exactness of the optimized program is property-tested
(``tests/test_opt.py``) and re-gated at serve time: ``verify_engine(engine,
original_prog)`` compares the engine built from the *optimized* program
against the *unoptimized* interpreter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analysis import RewriteObligations, validate_rewrite
from repro_torch.core.dais import (OP_DEPS, DaisProgram, Instr, Reg, Segment,
                             _requant)
from repro_torch.core.tables import LayerTables


# --------------------------------------------------------------------------- #
# report
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class DceReport:
    """What the pass removed — the numbers the Pareto bench reports."""

    n_instrs_before: int
    n_instrs_after: int
    n_llut_before: int
    n_llut_after: int
    n_const_folded: int                 # instructions replaced by constants
    gather_width_before: Dict[int, int]  # per lut layer: table c_in
    gather_width_after: Dict[int, int]
    dropped_rows: Dict[int, int]        # per lut layer: input rows removed
    # every claim the rewrite made, in checkable form; discharged by
    # core.analysis.validate_rewrite (self-certification is on by default)
    obligations: Optional[RewriteObligations] = None

    def total_gather_width(self) -> Tuple[int, int]:
        return (sum(self.gather_width_before.values()),
                sum(self.gather_width_after.values()))

    def summary(self) -> str:
        gw0, gw1 = self.total_gather_width()
        return (f"instrs {self.n_instrs_before} -> {self.n_instrs_after}, "
                f"live LLUTs {self.n_llut_before} -> {self.n_llut_after}, "
                f"gather width {gw0} -> {gw1} "
                f"({sum(self.dropped_rows.values())} table rows dropped, "
                f"{self.n_const_folded} consts folded)")


# --------------------------------------------------------------------------- #
# constant analysis
# --------------------------------------------------------------------------- #
def _llut_row(prog: DaisProgram, ins: Instr) -> Tuple[np.ndarray, int]:
    """Addressable slice of the truth-table row an LLUT instruction reads."""
    _src, lid, j, i = ins.args
    t = prog.tables[lid]
    m = int(t.in_width[j, i])
    size = (1 << m) if m > 0 else 1
    return np.asarray(t.codes[j, i, :size], np.int64), size


def _const_values(prog: DaisProgram) -> List[Optional[int]]:
    """Forward constant propagation over the SSA list (None = not constant)."""
    const: List[Optional[int]] = []
    for ins in prog.instrs:
        op, a = ins.op, ins.args
        c: Optional[int] = None
        if op == "CONST":
            c = int(a[0])
        elif op == "LLUT":
            row, size = _llut_row(prog, ins)
            src_c = const[a[0]]
            if src_c is not None:
                c = int(row[src_c % size])
            elif row.size and np.all(row == row[0]):
                c = int(row[0])
        elif op == "REQUANT":
            src, f, i, signed, mode, src_f = a
            if f + i + (1 if signed else 0) <= 0:
                c = 0                   # zero-width grid: always 0
            elif const[src] is not None:
                c = int(_requant(np.asarray([const[src]], np.int64),
                                 src_f, f, i, signed, mode)[0])
        elif op == "CMUL":
            src, code = a[0], a[1]
            if code == 0:
                c = 0
            elif const[src] is not None:
                c = int(const[src]) * int(code)
        elif op in ("ADD", "SUB"):
            ca, cb = const[a[0]], const[a[1]]
            if ca is not None and cb is not None:
                fa = prog.instrs[a[0]].reg.f
                fb = prog.instrs[a[1]].reg.f
                F = max(fa, fb)
                va, vb = ca << (F - fa), cb << (F - fb)
                c = va + vb if op == "ADD" else va - vb
        const.append(c)
    return const


# --------------------------------------------------------------------------- #
# the pass
# --------------------------------------------------------------------------- #
def eliminate_dead_cells(
        prog: DaisProgram, *,
        validate: bool = True) -> Tuple[DaisProgram, DceReport]:
    """Return ``(optimized, report)`` — a bit-exact smaller program.

    The optimized program computes identical output codes for every input
    (same ``input_f`` / ``output_f`` grids, same input layout — IN
    instructions are never removed so batched callers keep their column
    indexing), with constant cells folded, dead chains dropped, registers
    renumbered, and shared tables sliced down to their contributing rows.

    With ``validate`` (the default) the rewrite is *self-certifying*:
    every fold/alias/slice decision is recorded as a checkable obligation
    on ``report.obligations`` and statically discharged by
    ``core.analysis.validate_rewrite`` before the optimized program is
    returned — an unjustified rewrite raises instead of shipping.
    """
    n = len(prog.instrs)
    const = _const_values(prog)

    # --- simplification actions: const | alias | cmul-shift -------------- #
    # A register named by segment metadata must keep its declared (f,
    # width, signed) format: the fused composer requires site-uniform
    # formats per patch position, and pad-driven folds happen at SOME
    # sites only (conv borders).  Such registers get a format-preserving
    # CMUL·1 instead of a plain alias when the alias target's format
    # differs.
    seg_refs = {r for seg in prog.segments
                for r in (*seg.in_regs, *seg.out_regs)}

    def _fmt(r: int) -> tuple:
        reg = prog.instrs[r].reg
        return (reg.f, max(reg.width, 1), reg.signed)

    alias = [None] * n                    # idx -> replacement register
    shift_rw: Dict[int, Tuple[int, int]] = {}   # idx -> (src, signed code)

    def _collapse(idx: int, target: int, shift: int) -> None:
        """``idx`` computes ``target << shift``: alias when format-safe,
        else rewrite as a CMUL preserving the declared register."""
        if shift == 0 and (idx not in seg_refs or _fmt(idx) == _fmt(target)):
            alias[idx] = target
        else:
            shift_rw[idx] = (target, 1 << shift)

    for idx, ins in enumerate(prog.instrs):
        if const[idx] is not None or ins.op not in ("ADD", "SUB"):
            continue
        ra, rb = ins.args
        fa, fb = prog.instrs[ra].reg.f, prog.instrs[rb].reg.f
        F = max(fa, fb)
        if const[rb] == 0:                # x ± 0
            _collapse(idx, ra, F - fa)
        elif const[ra] == 0 and ins.op == "ADD":
            _collapse(idx, rb, F - fb)
        elif const[ra] == 0:              # 0 - x
            shift_rw[idx] = (rb, -(1 << (F - fb)))

    def resolve(r: int) -> int:
        while alias[r] is not None:
            r = alias[r]
        return r

    # --- liveness from the outputs (+ every IN: input layout is ABI) ----- #
    live = [False] * n

    def mark(roots: Sequence[int]) -> None:
        stack = [resolve(r) for r in roots]
        while stack:
            r = stack.pop()
            if live[r]:
                continue
            live[r] = True
            if const[r] is not None:
                continue                  # becomes a CONST leaf
            if r in shift_rw:
                stack.append(resolve(shift_rw[r][0]))
                continue
            ins = prog.instrs[r]
            stack.extend(resolve(ins.args[p]) for p in OP_DEPS[ins.op])

    mark(prog.outputs)
    mark(i for i, ins in enumerate(prog.instrs) if ins.op == "IN")

    # --- decide which shared-table rows survive -------------------------- #
    # A row stays iff a live, non-constant LLUT still reads it, or its
    # constant contribution is nonzero for some output (then the fused
    # stage keeps accounting for it through the stored codes).
    used_rows: Dict[int, set] = {lid: set() for lid in prog.tables}
    for idx, ins in enumerate(prog.instrs):
        if ins.op == "LLUT" and live[idx] and const[idx] is None:
            used_rows[ins.args[1]].add(int(ins.args[2]))
    keep_rows: Dict[int, np.ndarray] = {}
    row_map: Dict[int, Dict[int, int]] = {}
    for lid, t in prog.tables.items():
        keep = np.zeros(t.c_in, bool)
        for j in range(t.c_in):
            keep[j] = (j in used_rows[lid]) or bool(np.any(t.codes[j]))
        keep_rows[lid] = keep
        row_map[lid] = {int(j): k for k, j in enumerate(np.where(keep)[0])}

    # in_regs of kept rows must survive even when nothing reads them (the
    # fused gather still loads the column; a constant row ignores its value)
    for seg in prog.segments:
        if seg.kind == "lut" and seg.layer_id in keep_rows:
            keep = keep_rows[seg.layer_id]
            mark(r for j, r in enumerate(seg.in_regs)
                 if j < len(keep) and keep[j])

    # --- rebuild --------------------------------------------------------- #
    out = DaisProgram()
    out.input_f = list(prog.input_f)
    out.input_signed = list(prog.input_signed)
    new_of: Dict[int, int] = {}
    n_folded = 0
    for idx, ins in enumerate(prog.instrs):
        if not live[idx] or alias[idx] is not None:
            continue
        reg = ins.reg
        if const[idx] is not None and ins.op != "CONST":
            n_folded += 1
            # keep the ORIGINAL register format: the folded value is one the
            # instruction could produce, so it fits — and a tightened width
            # would make formats site-dependent (folded at one site, live at
            # another), demoting fused-eligible programs to the generic path
            new_of[idx] = out.emit(
                "CONST", (const[idx],),
                Reg(reg.f, max(reg.width, 1), reg.signed))
        elif const[idx] is not None:      # pre-existing CONST
            new_of[idx] = out.emit("CONST", ins.args, reg)
        elif idx in shift_rw:
            src, code = shift_rw[idx]
            new_of[idx] = out.emit(
                "CMUL", (new_of[resolve(src)], code, 0),
                Reg(reg.f, reg.width, reg.signed))
        else:
            args = list(ins.args)
            for p in OP_DEPS[ins.op]:
                args[p] = new_of[resolve(args[p])]
            if ins.op == "LLUT":          # remap j onto the sliced tables
                lid, j = args[1], int(args[2])
                args[2] = row_map[lid][j]
            new_of[idx] = out.emit(ins.op, tuple(args), reg)
    out.outputs = [new_of[resolve(r)] for r in prog.outputs]
    out.output_f = list(prog.output_f)

    # --- sliced tables ---------------------------------------------------- #
    for lid, t in prog.tables.items():
        keep = keep_rows[lid]
        out.tables[lid] = LayerTables(
            f_in=t.f_in[keep], i_in=t.i_in[keep],
            f_out=t.f_out[keep], i_out=t.i_out[keep],
            in_width=t.in_width[keep], out_width=t.out_width[keep],
            codes=t.codes[keep])

    # --- segments: remap registers, shrink lut in_regs -------------------- #
    # Registers that died (unobservable chains) are replaced by a cached
    # CONST 0 carrying the dead register's FULL (f, width, signed) format:
    # the fused composer requires site-uniform formats per patch position,
    # so a narrower stand-in would demote multi-site programs where a
    # register died at some sites but stayed live at others to the generic
    # runner.
    zero_regs: Dict[Tuple[int, int, bool], int] = {}

    def seg_reg(r: int) -> int:
        r = resolve(r)
        if r in new_of:
            return new_of[r]
        reg = prog.instrs[r].reg
        key = (reg.f, max(reg.width, 1), reg.signed)
        if key not in zero_regs:
            zero_regs[key] = out.emit(
                "CONST", (0,), Reg(reg.f, max(reg.width, 1), reg.signed))
        return zero_regs[key]

    for seg in prog.segments:
        in_regs = seg.in_regs
        if seg.kind == "lut" and seg.layer_id in keep_rows:
            keep = keep_rows[seg.layer_id]
            in_regs = tuple(r for j, r in enumerate(in_regs) if keep[j])
        out.segments.append(Segment(
            kind=seg.kind, layer_id=seg.layer_id,
            in_regs=tuple(seg_reg(r) for r in in_regs),
            out_regs=tuple(seg_reg(r) for r in seg.out_regs),
            site=seg.site, n_sites=seg.n_sites))

    obligations = RewriteObligations(
        const={i: int(c) for i, c in enumerate(const) if c is not None},
        alias={i: int(t) for i, t in enumerate(alias) if t is not None},
        shift_rw=dict(shift_rw),
        new_of=dict(new_of),
        keep_rows=dict(keep_rows),
        row_map={lid: dict(m) for lid, m in row_map.items()})
    report = DceReport(
        n_instrs_before=n, n_instrs_after=out.n_instrs(),
        n_llut_before=sum(1 for i in prog.instrs if i.op == "LLUT"),
        n_llut_after=sum(1 for i in out.instrs if i.op == "LLUT"),
        n_const_folded=n_folded,
        gather_width_before={lid: t.c_in for lid, t in prog.tables.items()},
        gather_width_after={lid: t.c_in for lid, t in out.tables.items()},
        dropped_rows={lid: int(np.sum(~keep_rows[lid]))
                      for lid in prog.tables},
        obligations=obligations)
    if validate:
        validate_rewrite(prog, out, obligations)
    return out, report


def verify_optimized(original: DaisProgram, optimized: DaisProgram, *,
                     n_random: int = 512, seed: int = 0,
                     exhaustive_limit: int = 4096) -> Dict[str, int]:
    """Interpreter-level bit-exactness gate: optimized vs original.

    The cheap CPU-only counterpart of ``kernels.lut_serve.verify_engine``
    (which gates the *engine built from the optimized program* against the
    original interpreter): random rows plus the exhaustive input
    cross-product when small enough (size test in the log domain so wide
    input spaces don't overflow).  Raises ``AssertionError`` on mismatch.
    """
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(original)
    rng = np.random.default_rng(seed)
    batches = [rng.integers(lo, hi + 1, (n_random, len(lo)), dtype=np.int64)]
    sizes = (hi - lo + 1).astype(np.float64)
    n_exhaustive = 0
    if np.sum(np.log2(sizes)) <= np.log2(exhaustive_limit):
        grid = np.indices(tuple(int(s) for s in (hi - lo + 1)))
        batches.append(grid.reshape(len(lo), -1).T + lo[None, :])
        n_exhaustive = batches[-1].shape[0]
    for codes in batches:
        np.testing.assert_array_equal(
            optimized.run(codes), original.run(codes),
            err_msg="DCE-optimized program != original program")
    return {"random": n_random, "exhaustive": n_exhaustive}


def verify_optimized_rtl(original: DaisProgram, optimized: DaisProgram,
                         **kw) -> Dict[str, object]:
    """Hardware-level DCE gate: the *optimized* program's emitted Verilog,
    run through the RTL simulator (``core.rtl_sim``), against the
    *unoptimized* interpreter.

    This is the strongest equivalence this pass can claim: DCE rewrites
    both the instruction stream and the shared tables, and the RTL emitter
    then renames registers, narrows index slices, and re-derives clamp
    widths — so a bug in either layer (or in their interaction, e.g. an
    aliased register narrowing an LLUT index slice out of range) shows up
    here even when the optimized *interpreter* still agrees.  Keyword
    arguments are forwarded to :func:`repro_torch.core.rtl.verify_rtl`.
    """
    from repro_torch.core.rtl import verify_rtl

    return verify_rtl(optimized, oracle=original, **kw)
