"""Verilog emission backend for DAIS programs (paper §IV-B), port of
``repro.core.rtl`` (numpy only; the text is the reference's, byte for byte).

Generates a single flat combinational module per program: L-LUT instructions
become case-statement functions (which synthesis maps onto logic LUTs),
REQUANTs become shift/round/clamp expressions, ADD/CMUL become plain
arithmetic.  This mirrors da4ml's Verilog flow; pipelining registers are the
synthesis tool's job (the paper relies on global retiming).

The emitted subset is **bit-exactly verified** against the DAIS interpreter
and the serving engine by :func:`verify_rtl`, which evaluates the Verilog
with the IEEE-semantics simulator in ``core/rtl_sim.py`` (self-determined
expression widths, wrap-on-assign, signed/unsigned extension rules) — the
three-way attestation closing Fig. 1's hardware loop.  Emission therefore
sizes every intermediate explicitly: requants compute their shifted (and,
for down-shifts, round-half-to-even) value on a dedicated full-width wire
before clamping, and all constants are *sized* literals — bare decimal
literals are 32-bit in Verilog, which silently truncates wide clamps and
CMUL codes.

Shared conv tables: the graph frontend (``core/lower.py``) stores one
``LayerTables`` per layer no matter how many spatial sites the layer has,
so this backend emits **one function per live table cell** and every site's
LLUT instruction simply *instantiates* (calls) it — the Verilog mirror of
the FPGA weight-sharing story.  Unsigned registers (relu outputs, unsigned
activation grids) are declared as unsigned wires and zero-extended where
they feed signed arithmetic.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.dais import DaisProgram


def _w(reg) -> int:
    return max(reg.width, 1)


def _decl(prog: DaisProgram, ridx: int) -> str:
    reg = prog.instrs[ridx].reg
    sign = "signed " if reg.signed else ""
    return f"  wire {sign}[{_w(reg)-1}:0] r{ridx}"


def _ref(prog: DaisProgram, ridx: int) -> str:
    """Reference a register inside signed arithmetic (zero-extend unsigned)."""
    if prog.instrs[ridx].reg.signed:
        return f"r{ridx}"
    return f"$signed({{1'b0, r{ridx}}})"


def _sized_signed(code: int, width: int) -> str:
    """A sized signed literal: unsized decimals are only 32 bits wide."""
    if code < 0:
        return f"-{width}'sd{-code}"
    return f"{width}'sd{code}"


def emit_verilog(prog: DaisProgram, name: str = "hgq_lut_model") -> str:
    lines: List[str] = []
    n_in = len(prog.input_f)
    in_w = [max(prog.instrs[k].reg.width, 1) for k in range(n_in)]

    ports = []
    for k in range(n_in):
        sign = "signed " if prog.input_signed[k] else ""
        ports.append(f"    input  wire {sign}[{in_w[k]-1}:0] in_{k}")
    for k, r in enumerate(prog.outputs):
        reg = prog.instrs[r].reg
        sign = "signed " if reg.signed else ""
        ports.append(f"    output wire {sign}[{_w(reg)-1}:0] out_{k}")
    lines.append(f"module {name} (")
    lines.append(",\n".join(ports))
    lines.append(");")

    # one function per live table cell, shared by every site that calls it.
    # "Live" means *referenced*: a cell pruned at training time, or whose
    # LLUT instructions were folded away by the DCE pass (core/opt.py),
    # gets no case function — dead cells must not survive into RTL.
    used_cells = {(ins.args[1], ins.args[2], ins.args[3])
                  for ins in prog.instrs if ins.op == "LLUT"}
    n_sites = {}
    for seg in prog.segments:
        if seg.kind == "lut":
            n_sites[seg.layer_id] = max(n_sites.get(seg.layer_id, 1),
                                        seg.n_sites)
    for lid, t in prog.tables.items():
        n_used = sum(1 for (l, _j, _i) in used_cells if l == lid)
        lines.append(f"  // layer {lid}: {n_used} shared table functions"
                     f", instantiated at {n_sites.get(lid, 1)} site(s)")
        for j in range(t.c_in):
            for i in range(t.c_out):
                m = int(t.in_width[j, i])
                n = int(t.out_width[j, i])
                if m <= 0 or n <= 0 or (lid, j, i) not in used_cells:
                    continue
                lines.append(f"  function automatic signed [{n-1}:0] llut_{lid}_{j}_{i};")
                lines.append(f"    input [{m-1}:0] idx;")
                lines.append("    begin")
                lines.append("      case (idx)")
                for e in range(1 << m):
                    code = int(t.codes[j, i, e]) & ((1 << n) - 1)
                    lines.append(f"        {m}'d{e}: llut_{lid}_{j}_{i} = {n}'d{code};")
                lines.append(f"        default: llut_{lid}_{j}_{i} = {n}'d0;")
                lines.append("      endcase")
                lines.append("    end")
                lines.append("  endfunction")

    for ridx, ins in enumerate(prog.instrs):
        w = _w(ins.reg)
        decl = _decl(prog, ridx)
        op, a = ins.op, ins.args
        if op == "IN":
            lines.append(f"{decl} = in_{a[0]};")
        elif op == "CONST":
            code = a[0] & ((1 << w) - 1)
            lines.append(f"{decl} = {w}'d{code};")
        elif op == "REQUANT":
            src, f, i, signed, mode, src_f = a
            shift = f - src_f
            sem_w = f + i + (1 if signed else 0)
            note = f"// requant f={f} i={i} {mode}"
            if sem_w <= 0:
                # target grid holds no codes: the interpreter yields 0
                lines.append(f"{decl} = {w}'d0;  {note} (empty grid)")
            else:
                src_reg = prog.instrs[src].reg
                ext_w = _w(src_reg) + (0 if src_reg.signed else 1)
                if shift >= 0:
                    # the shifted value needs ext_w + shift bits; computing
                    # it on a wire of that width makes the assignment
                    # context extend the source *before* the shift, so the
                    # clamp below never sees a wrapped intermediate
                    q_w = max(ext_w + shift, sem_w + 1)
                    q_rhs = (f"({_ref(prog, src)} <<< {shift})" if shift
                             else _ref(prog, src))
                else:
                    # round-half-to-even, matching dais._requant: with
                    # x' = x + (half-1) + lsb(x >>> s), floor(x' / 2^s)
                    # is exactly round-half-even(x / 2^s)
                    s = -shift
                    q_w = max(max(ext_w, s) + 2, sem_w + 1)
                    r = _ref(prog, src)
                    q_rhs = (f"(({r} + {_sized_signed((1 << (s - 1)) - 1, q_w)}"
                             f" + (({r} >>> {s}) & {q_w}'sd1)) >>> {s})")
                lines.append(f"  wire signed [{q_w-1}:0] r{ridx}_q = {q_rhs};")
                if mode == "SAT":
                    hi = (1 << (sem_w - 1)) - 1 if signed else (1 << sem_w) - 1
                    lo = -(1 << (sem_w - 1)) if signed else 0
                    hi_l = _sized_signed(hi, q_w)
                    lo_l = _sized_signed(lo, q_w)
                    lines.append(
                        f"{decl} = (r{ridx}_q > {hi_l} ? {hi_l} : "
                        f"(r{ridx}_q < {lo_l} ? {lo_l} : r{ridx}_q));  {note}")
                elif sem_w == w:
                    lines.append(f"{decl} = r{ridx}_q;  {note}")
                else:
                    # wrap onto the semantic width first, then let the
                    # assignment extend to the wider declared register with
                    # the target grid's signedness
                    sign = "signed " if signed else ""
                    lines.append(f"  wire {sign}[{sem_w-1}:0] r{ridx}_m"
                                 f" = r{ridx}_q;")
                    lines.append(f"{decl} = r{ridx}_m;  {note}")
        elif op == "LLUT":
            src, lid, j, i = a
            t = prog.tables[lid]
            m = int(t.in_width[j, i])
            src_w = _w(prog.instrs[src].reg)
            # slice only when the source is wider than the table input: a
            # part-select past the declared width reads x bits (DCE alias
            # collapse can legally narrow the index source).  A narrower
            # source coerces onto the m-bit function input by assignment,
            # extending with the source's signedness — exactly idx mod 2^m.
            idx = f"r{src}[{m-1}:0]" if src_w > m else f"r{src}"
            lines.append(f"{decl} = llut_{lid}_{j}_{i}({idx});")
        elif op == "CMUL":
            src, code, _f = a
            cw = max(abs(int(code)).bit_length() + 1, 1)
            lines.append(f"{decl} = {_ref(prog, src)} * "
                         f"{_sized_signed(int(code), cw)};")
        elif op in ("ADD", "SUB"):
            # align operands onto the common grid f = max(fa, fb), exactly
            # as the interpreter does (dais.run) — mixed-grid adds are legal
            sym = "+" if op == "ADD" else "-"
            fa = prog.instrs[a[0]].reg.f
            fb = prog.instrs[a[1]].reg.f
            f = max(fa, fb)
            ea = _ref(prog, a[0]) if f == fa else \
                f"({_ref(prog, a[0])} <<< {f - fa})"
            eb = _ref(prog, a[1]) if f == fb else \
                f"({_ref(prog, a[1])} <<< {f - fb})"
            lines.append(f"{decl} = {ea} {sym} {eb};")
        else:
            raise ValueError(op)

    for k, r in enumerate(prog.outputs):
        lines.append(f"  assign out_{k} = r{r};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def verify_rtl(prog: DaisProgram, module_src: Optional[str] = None, *,
               oracle: Optional[DaisProgram] = None, engine=None,
               n_random: int = 512, seed: int = 0,
               exhaustive_limit: int = 4096,
               name: str = "hgq_lut_model") -> Dict[str, object]:
    """Assert the emitted Verilog matches the DAIS interpreter bit-for-bit.

    Evaluates ``module_src`` (emitted from ``prog`` when not given) with the
    Verilog-semantics simulator (``core/rtl_sim.py``) on ``n_random``
    uniform input-code vectors plus the full input cross-product whenever it
    has at most ``exhaustive_limit`` rows — the same gate shape as
    ``kernels.lut_serve.verify_engine``.

    ``oracle`` is the reference program to interpret (defaults to ``prog``);
    passing the *unoptimized* program while emitting RTL from a DCE'd one
    verifies optimized hardware against the original semantics.  When
    ``engine`` (a ``ServeEngine``) is given, its outputs are checked on the
    same rows, making the attestation three-way: RTL sim == interpreter ==
    serving engine (on whatever device it was compiled for).

    Raises ``AssertionError`` on the first mismatch.  Returns the
    attestation record — row counts, wire count, the engine path, and the
    SHA-256 of the Verilog source — which callers embed in artifact
    bundles (``serve/artifact.py``).
    """
    from repro_torch.core.rtl_sim import RtlModule
    from repro_torch.kernels.lut_serve import input_code_bounds

    if module_src is None:
        module_src = emit_verilog(prog, name=name)
    if oracle is None:
        oracle = prog
    sim = RtlModule.parse(module_src)

    lo, hi = input_code_bounds(prog)    # DCE preserves the input ABI
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
        ref = oracle.run(codes)
        got = sim.run(codes)
        np.testing.assert_array_equal(
            got, ref, err_msg="RTL simulation != DAIS interpreter")
        if engine is not None:
            # the engine's outputs come to the host by ``.cpu()``: on a card
            # they stay the card's, never an interpreter's stand-in
            eng = engine.run(codes).cpu().numpy().astype(np.int64)
            np.testing.assert_array_equal(
                eng, ref, err_msg="serving engine != DAIS interpreter")
    return {"random": int(n_random), "exhaustive": int(n_exhaustive),
            "n_wires": sim.n_wires,
            "engine_path": getattr(engine, "path", None),
            "verilog_sha256": hashlib.sha256(module_src.encode()).hexdigest(),
            "verdict": "bit-exact"}
