"""DAIS — distributed-arithmetic instruction set with the L-LUT extension.

A copy of ``repro.core.dais`` for the PyTorch port (numpy only; the table
type comes from ``repro_torch.core.tables``), so the wire format and the
interpreter are the reference's, array for array.

The paper extends da4ml's internal IR with a logic-lookup instruction so that
LUT-layers, quantizers and plain fixed-point arithmetic live in one program
that can be (a) interpreted bit-exactly on CPU (up to 64-bit internal width)
and (b) emitted as RTL.  We reproduce that layer: a linear SSA program over
integer *codes*, each register annotated with its fixed-point format
(fractional bits ``f``, signedness, width).

Instructions
------------
``IN k``                read scalar k of the program input vector
``CONST c``            integer constant code
``REQUANT r,(f,i,s,mode)``  re-quantize register r onto a new grid
``LLUT r,(layer,j,i)``  truth-table lookup (tables stored on the program)
``CMUL r,(code,f)``     multiply by a fixed-point constant (exact in ints)
``ADD a,b`` / ``SUB a,b``  aligned fixed-point add/sub (result f = max)
``OUT r``              append register r to the output vector

The interpreter vectorises over a leading batch axis (register values are
int64 arrays of shape (B,)), mirroring da4ml's batched emulation mode.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.tables import LayerTables


# Operand positions of each op's args tuple — the single source of truth
# for dependency walks (schedule() levelization here, liveness in
# the reference's core/opt.py).  New ops must be added here once, not per consumer.
OP_DEPS: Dict[str, Tuple[int, ...]] = {
    "IN": (), "CONST": (),
    "REQUANT": (0,), "LLUT": (0,), "CMUL": (0,),
    "ADD": (0, 1), "SUB": (0, 1),
}


@dataclasses.dataclass
class Reg:
    """Static metadata of one SSA register."""

    f: int          # fractional bits of the code grid
    width: int      # total physical bits (incl. sign)
    signed: bool


@dataclasses.dataclass
class Instr:
    op: str
    args: tuple
    reg: Reg        # metadata of the produced value


@dataclasses.dataclass(frozen=True)
class OpGroup:
    """One vectorizable batch of same-op instructions at one dataflow level.

    ``DaisProgram.schedule`` levelizes the SSA program (level = 1 + max level
    of the arguments) and batches instructions by ``(level, op, mode)``.  All
    instructions in a group are mutually independent and argument-ready once
    every earlier group has executed, so a backend can run the whole group as
    a handful of array ops over the batch axis — this is the instruction view
    the serving engine (``kernels/lut_serve.py``) lowers from.

    ``regs`` holds the producing instruction indices in group-column order;
    ``args`` holds per-op int64 numpy arrays, one entry per column:

    ======== ==========================================================
    op       args keys
    ======== ==========================================================
    IN       ``k`` (input scalar index)
    CONST    ``c`` (constant code)
    REQUANT  ``src, f, i, signed, src_f``  (``mode`` is the group mode)
    LLUT     ``src, layer, j, i``
    CMUL     ``src, code``
    ADD/SUB  ``a, b, shift_a, shift_b, f`` (operand left-shifts onto the
             common grid ``f = max(fa, fb)``)
    ======== ==========================================================
    """

    level: int
    op: str
    mode: str                    # REQUANT overflow mode; "" for other ops
    regs: np.ndarray             # (n,) int64 instruction indices produced
    args: Dict[str, np.ndarray]  # (n,) int64 arrays, see table above


@dataclasses.dataclass(frozen=True)
class Segment:
    """One lowered (layer, spatial site)'s span in the flat program.

    The graph frontend (``core/lower.py``) records a Segment per layer *and
    per spatial site* so backends can recover the structure the SSA list
    flattens away: ``in_regs`` are the registers the site consumed (a patch
    of the previous layer's ``out_regs``, IN instructions, or zero-pad
    CONSTs) and ``out_regs`` its per-channel results.  All ``n_sites``
    segments of one convolutional layer share ``layer_id`` — and therefore
    one entry in ``DaisProgram.tables`` — which is the FPGA weight-sharing
    story: one table set per layer, many LLUT instructions.  The accelerator
    engine uses this to compose each layer's tables once and gather
    per-site; backends that don't understand a segment can always fall back
    to the flat instruction list.
    """

    kind: str                    # "lut" | "hgq" | "acc" | "relu"
    layer_id: int
    in_regs: Tuple[int, ...]
    out_regs: Tuple[int, ...]
    site: int = 0                # spatial site index within the layer
    n_sites: int = 1             # sites sharing tables[layer_id]


@dataclasses.dataclass
class DaisProgram:
    instrs: List[Instr] = dataclasses.field(default_factory=list)
    outputs: List[int] = dataclasses.field(default_factory=list)
    input_f: List[int] = dataclasses.field(default_factory=list)
    input_signed: List[bool] = dataclasses.field(default_factory=list)
    tables: Dict[int, LayerTables] = dataclasses.field(default_factory=dict)
    output_f: List[int] = dataclasses.field(default_factory=list)
    segments: List["Segment"] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------- construction
    def emit(self, op: str, args: tuple, reg: Reg) -> int:
        self.instrs.append(Instr(op, args, reg))
        if reg.width > 64:
            raise OverflowError(
                f"register width {reg.width} exceeds the 64-bit interpreter "
                f"limit (op={op})")
        return len(self.instrs) - 1

    def n_instrs(self) -> int:
        return len(self.instrs)

    def count_ops(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for ins in self.instrs:
            c[ins.op] = c.get(ins.op, 0) + 1
        return c

    def max_width(self) -> int:
        """Widest register of the program (bounds the interpreter dtype)."""
        return max((ins.reg.width for ins in self.instrs), default=0)

    def required_width(self) -> int:
        """Width bound covering *transient* values, not just declared registers.

        A SAT REQUANT up-shifts its source before clamping and an ADD/SUB
        aligns operands onto the common grid before the declared-width result
        exists, so a backend computing in a fixed dtype must size it off this
        bound rather than :meth:`max_width`.
        """
        need = self.max_width()
        for ins in self.instrs:
            if ins.op == "REQUANT":
                src, f, _i, _signed, _mode, src_f = ins.args
                need = max(need,
                           self.instrs[src].reg.width + max(f - src_f, 0) + 1)
            elif ins.op in ("ADD", "SUB"):
                ra, rb = ins.args
                fa, fb = self.instrs[ra].reg.f, self.instrs[rb].reg.f
                F = max(fa, fb)
                need = max(need,
                           self.instrs[ra].reg.width + (F - fa) + 1,
                           self.instrs[rb].reg.width + (F - fb) + 1)
        return need

    # ------------------------------------------------- levelized batch view
    def schedule(self) -> List["OpGroup"]:
        """Levelize the program into vectorizable :class:`OpGroup` batches.

        Executing the groups in order (all columns of a group at once)
        computes exactly the same register values as :meth:`run`'s
        instruction-at-a-time loop — the grouping only exposes the data
        parallelism that the flat SSA list hides.
        """
        level = np.zeros(len(self.instrs), np.int64)
        for idx, ins in enumerate(self.instrs):
            srcs = [ins.args[p] for p in OP_DEPS[ins.op]]
            level[idx] = 1 + max((level[s] for s in srcs), default=-1)

        buckets: Dict[Tuple[int, str, str], List[int]] = {}
        for idx, ins in enumerate(self.instrs):
            mode = ins.args[4] if ins.op == "REQUANT" else ""
            buckets.setdefault((int(level[idx]), ins.op, mode), []).append(idx)

        groups: List[OpGroup] = []
        for (lvl, op, mode), idxs in sorted(buckets.items(),
                                            key=lambda kv: kv[0][:2]):
            cols = {}
            ins0 = [self.instrs[i] for i in idxs]
            if op == "IN":
                cols["k"] = [ins.args[0] for ins in ins0]
            elif op == "CONST":
                cols["c"] = [ins.args[0] for ins in ins0]
            elif op == "REQUANT":
                for key, pos in (("src", 0), ("f", 1), ("i", 2),
                                 ("signed", 3), ("src_f", 5)):
                    cols[key] = [ins.args[pos] for ins in ins0]
            elif op == "LLUT":
                for key, pos in (("src", 0), ("layer", 1), ("j", 2), ("i", 3)):
                    cols[key] = [ins.args[pos] for ins in ins0]
            elif op == "CMUL":
                cols["src"] = [ins.args[0] for ins in ins0]
                cols["code"] = [ins.args[1] for ins in ins0]
            else:  # ADD / SUB
                cols["a"] = [ins.args[0] for ins in ins0]
                cols["b"] = [ins.args[1] for ins in ins0]
                fa = np.asarray([self.instrs[ins.args[0]].reg.f for ins in ins0])
                fb = np.asarray([self.instrs[ins.args[1]].reg.f for ins in ins0])
                F = np.maximum(fa, fb)
                cols["shift_a"], cols["shift_b"], cols["f"] = F - fa, F - fb, F
            groups.append(OpGroup(
                level=lvl, op=op, mode=mode,
                regs=np.asarray(idxs, np.int64),
                args={k: np.asarray(v, np.int64) for k, v in cols.items()}))
        return groups

    # ---------------------------------------------------------- interpreter
    def run(self, x_codes: np.ndarray) -> np.ndarray:
        """Bit-exact batched evaluation.

        ``x_codes``: (B, n_inputs) int64 input codes (on the grids declared in
        ``input_f``).  Returns (B, n_outputs) int64 codes on ``output_f``.
        """
        x_codes = np.asarray(x_codes, np.int64)
        if x_codes.ndim == 1:
            x_codes = x_codes[None]
        vals: List[np.ndarray] = []
        for ins in self.instrs:
            op, a = ins.op, ins.args
            if op == "IN":
                v = x_codes[:, a[0]]
            elif op == "CONST":
                v = np.full(x_codes.shape[:1], a[0], np.int64)
            elif op == "REQUANT":
                src, f, i, signed, mode, src_f = a
                v = _requant(vals[src], src_f, f, i, signed, mode)
            elif op == "LLUT":
                src, layer_id, j, i = a
                t = self.tables[layer_id]
                m = int(t.in_width[j, i])
                size = 1 << m if m > 0 else 1
                idx = np.mod(vals[src], size)
                v = t.codes[j, i, idx]
            elif op == "CMUL":
                src, code, _f = a
                v = vals[src] * np.int64(code)
            elif op in ("ADD", "SUB"):
                ra, rb = a
                fa, fb = self.instrs[ra].reg.f, self.instrs[rb].reg.f
                F = max(fa, fb)
                va = vals[ra] << np.int64(F - fa)
                vb = vals[rb] << np.int64(F - fb)
                v = va + vb if op == "ADD" else va - vb
            else:
                raise ValueError(f"unknown op {op}")
            vals.append(v.astype(np.int64))
        return np.stack([vals[r] for r in self.outputs], axis=-1)

    def run_float(self, x: np.ndarray) -> np.ndarray:
        """Convenience: float inputs -> float outputs (quantizing at the edges)."""
        x = np.asarray(x, np.float64)
        codes = np.empty(x.shape, np.int64)
        for k, (f, s) in enumerate(zip(self.input_f, self.input_signed)):
            # inputs are assumed pre-quantized; map to the declared grid
            codes[..., k] = np.round(x[..., k] * np.exp2(f)).astype(np.int64)
        out = self.run(codes)
        return out.astype(np.float64) * np.exp2(-np.asarray(self.output_f, np.float64))

    # ------------------------------------------------------------ wire format
    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flatten the program to a dict of plain numpy arrays.

        The inverse of :meth:`from_arrays`; together they are the
        npz-serializable wire format of the reference's compiled-artifact
        cache (``repro/serve/artifact.py``).  Everything semantic round-trips:
        instructions (with exact arg tuples), register formats, outputs,
        input/output grids, segments, and the truth tables — so a
        deserialized program runs bit-identically *and* still qualifies for
        the fused per-layer engine lowering.
        """
        return _program_to_arrays(self)

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray]) -> "DaisProgram":
        """Rebuild a program from :meth:`to_arrays` output."""
        return _program_from_arrays(arrays)


# --------------------------------------------------------------------------- #
# serialization: flat numpy-array round trip (the artifact-bundle format)
# --------------------------------------------------------------------------- #
# Stable enumerations of the wire format — append-only: the artifact cache
# (repro/serve/artifact.py) content-hashes the arrays produced here, so
# reordering an existing entry would silently invalidate every saved bundle.
#
# Version history (``from_arrays`` negotiates all of them):
#   1 — flat sequential programs; seg_meta is (n, 4): kind, layer_id,
#       n_in, n_out (one segment per layer).
#   2 — graph-lowered programs; seg_meta grows to (n, 6) with the spatial
#       ``site``/``n_sites`` columns, and segment kinds "acc"/"relu" exist.
#       Shared conv tables need no new arrays: many segments simply point
#       at the same ``table{lid}_*`` entry (stored once — the dedup).
_OP_CODES: Tuple[str, ...] = ("IN", "CONST", "REQUANT", "LLUT", "CMUL",
                              "ADD", "SUB")
_MODE_CODES: Tuple[str, ...] = ("", "SAT", "WRAP")
_SEG_KINDS: Tuple[str, ...] = ("lut", "hgq", "acc", "relu")
_TABLE_FIELDS: Tuple[str, ...] = ("f_in", "i_in", "f_out", "i_out",
                                  "in_width", "out_width", "codes")
_MAX_ARGS = 6  # REQUANT is the widest op: (src, f, i, signed, mode, src_f)
WIRE_VERSION = 2
_WIRE_VERSIONS = (1, 2)


def _program_to_arrays(prog: "DaisProgram") -> Dict[str, np.ndarray]:
    n = len(prog.instrs)
    op = np.zeros(n, np.int64)
    nargs = np.zeros(n, np.int64)
    args = np.zeros((n, _MAX_ARGS), np.int64)
    reg = np.zeros((n, 3), np.int64)
    for idx, ins in enumerate(prog.instrs):
        op[idx] = _OP_CODES.index(ins.op)
        a = list(ins.args)
        if ins.op == "REQUANT":
            a[4] = _MODE_CODES.index(a[4])
        nargs[idx] = len(a)
        args[idx, :len(a)] = [int(v) for v in a]
        reg[idx] = (ins.reg.f, ins.reg.width, int(ins.reg.signed))

    # segments: fixed-width metadata + one concatenated register list
    seg_meta = np.asarray(
        [[_SEG_KINDS.index(s.kind), s.layer_id, len(s.in_regs),
          len(s.out_regs), s.site, s.n_sites]
         for s in prog.segments], np.int64).reshape(-1, 6)
    seg_regs = np.asarray(
        [r for s in prog.segments for r in (*s.in_regs, *s.out_regs)],
        np.int64)

    out = {
        "version": np.asarray([WIRE_VERSION], np.int64),
        "instr_op": op, "instr_nargs": nargs, "instr_args": args,
        "instr_reg": reg,
        "outputs": np.asarray(prog.outputs, np.int64),
        "input_f": np.asarray(prog.input_f, np.int64),
        "input_signed": np.asarray(prog.input_signed, np.int64),
        "output_f": np.asarray(prog.output_f, np.int64),
        "seg_meta": seg_meta, "seg_regs": seg_regs,
        "table_ids": np.asarray(sorted(prog.tables), np.int64),
    }
    for lid in sorted(prog.tables):
        t = prog.tables[lid]
        for fld in _TABLE_FIELDS:
            out[f"table{lid}_{fld}"] = np.asarray(getattr(t, fld))
    return out


def _program_from_arrays(arrays: Dict[str, np.ndarray]) -> "DaisProgram":
    version = int(np.asarray(arrays["version"]).ravel()[0])
    if version not in _WIRE_VERSIONS:
        raise ValueError(
            f"unknown DaisProgram wire-format version {version} "
            f"(this reader understands {_WIRE_VERSIONS})")
    prog = DaisProgram()
    op, nargs = arrays["instr_op"], arrays["instr_nargs"]
    args, reg = arrays["instr_args"], arrays["instr_reg"]
    for idx in range(len(op)):
        name = _OP_CODES[int(op[idx])]
        a = [int(v) for v in args[idx, :int(nargs[idx])]]
        if name == "REQUANT":
            a[3] = bool(a[3])
            a[4] = _MODE_CODES[a[4]]
        prog.instrs.append(Instr(name, tuple(a),
                                 Reg(f=int(reg[idx, 0]), width=int(reg[idx, 1]),
                                     signed=bool(reg[idx, 2]))))
    prog.outputs = [int(r) for r in arrays["outputs"]]
    prog.input_f = [int(f) for f in arrays["input_f"]]
    prog.input_signed = [bool(s) for s in arrays["input_signed"]]
    prog.output_f = [int(f) for f in arrays["output_f"]]
    cursor = 0
    seg_regs = arrays["seg_regs"]
    seg_meta = np.asarray(arrays["seg_meta"], np.int64)
    if version == 1:  # v1 segments predate the site axis: one site per layer
        pad = np.broadcast_to(np.asarray([0, 1], np.int64),
                              (seg_meta.shape[0], 2))
        seg_meta = np.concatenate([seg_meta, pad], axis=1)
    for kind, lid, n_in, n_out, site, n_sites in seg_meta:
        regs = [int(r) for r in seg_regs[cursor:cursor + n_in + n_out]]
        cursor += n_in + n_out
        prog.segments.append(Segment(
            kind=_SEG_KINDS[int(kind)], layer_id=int(lid),
            in_regs=tuple(regs[:n_in]), out_regs=tuple(regs[n_in:]),
            site=int(site), n_sites=int(n_sites)))
    for lid in arrays["table_ids"]:
        fields = {fld: np.asarray(arrays[f"table{int(lid)}_{fld}"])
                  for fld in _TABLE_FIELDS}
        prog.tables[int(lid)] = LayerTables(**fields)
    return prog


def _requant(v: np.ndarray, src_f: int, f: int, i: int, signed: bool, mode: str) -> np.ndarray:
    """Exact integer re-quantization between fixed-point grids."""
    shift = f - src_f
    if shift >= 0:
        code = v << np.int64(shift)
    else:
        # round-half-to-even on the dropped bits, matching np.round/jnp.round
        s = -shift
        floor = v >> np.int64(s)
        rem = v - (floor << np.int64(s))
        half = np.int64(1) << np.int64(s - 1)
        code = np.where(rem > half, floor + 1,
                        np.where(rem < half, floor,
                                 floor + (floor & 1)))  # ties -> even
    width = f + i + (1 if signed else 0)
    if width <= 0:
        return np.zeros_like(v)
    n_codes = np.int64(1) << np.int64(width)
    lo = -(n_codes >> 1) if signed else np.int64(0)
    hi = lo + n_codes - 1
    if mode == "SAT":
        return np.clip(code, lo, hi)
    return lo + np.mod(code - lo, n_codes)


def _tree_add(prog: DaisProgram, regs: List[int], f: int) -> int:
    """Balanced adder tree (width grows log2(n), matching da4ml's reduction
    hardware rather than a linear accumulator chain)."""
    assert regs
    while len(regs) > 1:
        nxt = []
        for a, b in zip(regs[::2], regs[1::2]):
            w = max(prog.instrs[a].reg.width, prog.instrs[b].reg.width) + 1
            nxt.append(prog.emit("ADD", (a, b), Reg(f, w, True)))
        if len(regs) % 2:
            nxt.append(regs[-1])
        regs = nxt
    return regs[0]


# --------------------------------------------------------------------------- #
# frontend: lives in core/lower.py (graph lowering with a per-layer-type
# registry); this wrapper keeps the reference's import path.
# --------------------------------------------------------------------------- #
def compile_sequential(layers: Sequence, input_f: int, input_i: int,
                       input_signed: bool = True, *,
                       optimize: bool = False) -> DaisProgram:
    """Lower a flat list of (``LUTDense`` | ``HGQDense``) layers to DAIS.

    A thin wrapper over ``repro_torch.core.lower.compile_sequential``
    (imported here, at the call, because ``core/lower.py`` imports this
    module); ``core.lower.lower`` is the general entry point.
    ``optimize=True`` additionally runs dead-cell elimination
    (``repro_torch.core.opt``).
    """
    from repro_torch.core.lower import compile_sequential as _impl

    return _impl(layers, input_f, input_i, input_signed, optimize=optimize)
