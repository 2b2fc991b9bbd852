"""A pure-Python Verilog simulator for the subset ``emit_verilog`` produces,
port of ``repro.core.rtl_sim`` (numpy only).

The RTL backend (``core/rtl.py``) emits one flat combinational module per
DAIS program.  This module evaluates that Verilog **with Verilog semantics**
— not by re-implementing the DAIS ops in numpy, which would faithfully
reproduce the emitter's *intent* and therefore share its bugs.  The
evaluator implements the IEEE 1364 expression rules the emitted subset
exercises:

* **self-determined expression widths** — ``a + b`` is ``max(w_a, w_b)``
  bits, ``a <<< s`` is ``w_a`` bits, ``a * b`` is ``max`` (not sum), a
  comparison is 1 bit with its operands sized against each other only;
* **context propagation** — in ``wire [w-1:0] x = expr;`` the RHS is
  evaluated at ``max(w, self_size(expr))`` bits and *truncated* on assign
  (wrap-on-assign is what makes WRAP requants work);
* **signed/unsigned extension** — an operand is sign-extended only when the
  whole expression is signed; a signed value feeding an unsigned expression
  is zero-extended (the LRM conversion rule), concatenations and
  part-selects are unsigned, ``$signed`` casts reinterpret;
* **unsized decimal literals are 32-bit signed** (strict LRM reading):
  a bare ``8589934592`` silently truncates, which is exactly the class of
  emitter bug this simulator exists to catch;
* ``>>>`` is an arithmetic shift only when its left operand is signed.

Supported constructs: module header with ``input``/``output wire`` ports,
``wire [signed] [w:0] name = expr;`` declarations, ``assign``,
``function automatic`` bodies containing a single full ``case`` table,
``$signed``, concatenation ``{...}``, part-select ``r[a:b]``, ternary,
``+ - * & | ^``, ``<< >> <<< >>>``, comparisons, and sized/unsized decimal
(or binary/hex) literals.  Four-state values (``x``/``z``) are not
modelled; constructs whose IEEE semantics would produce them — e.g. an
out-of-range part-select — raise :class:`RtlSimError` instead of silently
guessing, so they surface as verification failures.

Evaluation is vectorized: register values are ``(B,)`` ``uint64`` arrays
holding the wire's bit pattern, so :meth:`RtlModule.run` has the same
batched contract as ``DaisProgram.run``.  Widths above 64 bits are
rejected (the DAIS interpreter shares that limit).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_M64 = (1 << 64) - 1


class RtlSimError(Exception):
    """Verilog outside the simulated subset, or with x-producing semantics."""


# --------------------------------------------------------------------------- #
# bit-pattern helpers (values are uint64 scalars/arrays masked to a width)
# --------------------------------------------------------------------------- #
def _u64(x: int) -> np.uint64:
    return np.uint64(x & _M64)


def _mask(w: int) -> np.uint64:
    if w >= 64:
        return np.uint64(_M64)
    return np.uint64((1 << w) - 1)


def _extend(bits, w_from: int, w_to: int, signed: bool):
    """Resize a ``w_from``-bit pattern to ``w_to`` bits.

    Truncates when narrowing; sign- or zero-extends when widening — the
    one primitive behind assignment coercion, operand context extension
    and ``$signed`` reinterpretation.
    """
    if w_to <= w_from:
        return bits & _mask(w_to)
    if signed and w_from > 0:
        sign = (bits >> _u64(w_from - 1)) & _u64(1)
        return bits | (sign * (_mask(w_to) ^ _mask(w_from)))
    return bits


def _as_int(bits, w: int, signed: bool):
    """Interpret a ``w``-bit pattern as an integer (int64 view)."""
    v = _extend(bits, w, 64, signed)
    if isinstance(v, np.ndarray):
        return v.view(np.int64) if signed else v
    return v.view(np.int64) if signed else v


# --------------------------------------------------------------------------- #
# AST
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _Num:
    width: int
    signed: bool
    bits: int          # already masked to ``width``
    sized: bool


@dataclasses.dataclass
class _Id:
    name: str


@dataclasses.dataclass
class _Slice:
    name: str
    msb: int
    lsb: int


@dataclasses.dataclass
class _Concat:
    parts: list


@dataclasses.dataclass
class _Cast:
    a: object
    signed: bool       # $signed / $unsigned


@dataclasses.dataclass
class _Unary:
    op: str
    a: object


@dataclasses.dataclass
class _Bin:
    op: str
    a: object
    b: object


@dataclasses.dataclass
class _Tern:
    c: object
    a: object
    b: object


@dataclasses.dataclass
class _Call:
    name: str
    arg: object


@dataclasses.dataclass
class _Port:
    name: str
    width: int
    signed: bool
    direction: str     # "input" | "output"


@dataclasses.dataclass
class _Wire:
    name: str
    width: int
    signed: bool
    expr: object


@dataclasses.dataclass
class _Func:
    name: str
    n: int             # return width
    signed: bool       # return signedness
    m: int             # input width
    table: np.ndarray  # (1 << m,) uint64 bit patterns masked to n


# --------------------------------------------------------------------------- #
# tokenizer
# --------------------------------------------------------------------------- #
_TOKEN_RE = re.compile(
    r"""\s+|//[^\n]*|/\*.*?\*/
      | (?P<sized>\d+'s?[dbhDBH][0-9a-fA-F_]+)
      | (?P<num>\d+)
      | (?P<id>\$?[A-Za-z_][A-Za-z0-9_]*)
      | (?P<op><<<|>>>|<<|>>|<=|>=|==|!=|[?:+\-*&|^(){}\[\],;=<>])
    """, re.X | re.S)

_KEYWORDS = {"module", "endmodule", "input", "output", "wire", "signed",
             "assign", "function", "endfunction", "automatic", "begin",
             "end", "case", "endcase", "default"}


def _tokenize(src: str) -> List[Tuple[str, str]]:
    toks: List[Tuple[str, str]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            snippet = src[pos:pos + 20]
            raise RtlSimError(f"cannot tokenize at {snippet!r}")
        pos = m.end()
        if m.lastgroup is None:
            continue            # whitespace / comment
        toks.append((m.lastgroup, m.group()))
    return toks


def _parse_literal(kind: str, text: str) -> _Num:
    if kind == "num":
        # unsized decimal: 32-bit *signed* per the LRM — larger values
        # truncate, which is the pitfall sized emission must avoid
        return _Num(width=32, signed=True, bits=int(text) & ((1 << 32) - 1),
                    sized=False)
    m = re.fullmatch(r"(\d+)'(s?)([dbhDBH])([0-9a-fA-F_]+)", text)
    if m is None:
        raise RtlSimError(f"bad literal {text!r}")
    width = int(m.group(1))
    signed = m.group(2) == "s"
    base = {"d": 10, "b": 2, "h": 16}[m.group(3).lower()]
    value = int(m.group(4).replace("_", ""), base)
    if width <= 0 or width > 64:
        raise RtlSimError(f"literal width {width} out of range: {text!r}")
    return _Num(width=width, signed=signed,
                bits=value & ((1 << width) - 1) if width < 64 else value & _M64,
                sized=True)


# --------------------------------------------------------------------------- #
# parser (recursive descent over the emitted grammar)
# --------------------------------------------------------------------------- #
class _Parser:
    def __init__(self, toks: List[Tuple[str, str]]):
        self.toks = toks
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.pos][1] if self.pos < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        if self.pos >= len(self.toks):
            raise RtlSimError("unexpected end of module source")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, text: str) -> None:
        kind, got = self.next()
        if got != text:
            raise RtlSimError(f"expected {text!r}, got {got!r}")

    def accept(self, text: str) -> bool:
        if self.peek() == text:
            self.pos += 1
            return True
        return False

    def ident(self) -> str:
        kind, got = self.next()
        if kind != "id" or got in _KEYWORDS:
            raise RtlSimError(f"expected identifier, got {got!r}")
        return got

    def integer(self) -> int:
        kind, got = self.next()
        if kind != "num":
            raise RtlSimError(f"expected integer, got {got!r}")
        return int(got)

    def range_width(self) -> int:
        """``[msb:lsb]`` with lsb 0 -> width; absent range -> 1 bit."""
        if not self.accept("["):
            return 1
        msb = self.integer()
        self.expect(":")
        lsb = self.integer()
        self.expect("]")
        if lsb != 0 or msb < 0:
            raise RtlSimError(f"unsupported range [{msb}:{lsb}]")
        return msb + 1

    # ------------------------------------------------------------ expressions
    def expr(self):
        return self.ternary()

    def ternary(self):
        c = self.comparison()
        if self.accept("?"):
            a = self.ternary()
            self.expect(":")
            b = self.ternary()
            return _Tern(c, a, b)
        return c

    def comparison(self):
        lhs = self.bitwise()
        while self.peek() in (">", "<", ">=", "<=", "==", "!="):
            op = self.next()[1]
            lhs = _Bin(op, lhs, self.bitwise())
        return lhs

    def bitwise(self):
        lhs = self.shift()
        while self.peek() in ("&", "|", "^"):
            op = self.next()[1]
            lhs = _Bin(op, lhs, self.shift())
        return lhs

    def shift(self):
        lhs = self.additive()
        while self.peek() in ("<<<", ">>>", "<<", ">>"):
            op = self.next()[1]
            lhs = _Bin(op, lhs, self.additive())
        return lhs

    def additive(self):
        lhs = self.multiplicative()
        while self.peek() in ("+", "-"):
            op = self.next()[1]
            lhs = _Bin(op, lhs, self.multiplicative())
        return lhs

    def multiplicative(self):
        lhs = self.unary()
        while self.peek() == "*":
            self.next()
            lhs = _Bin("*", lhs, self.unary())
        return lhs

    def unary(self):
        if self.accept("-"):
            a = self.unary()
            if isinstance(a, _Num):     # fold: same width, negated pattern
                return _Num(a.width, a.signed,
                            (-a.bits) & int(_mask(a.width)), a.sized)
            return _Unary("-", a)
        if self.accept("+"):
            return self.unary()
        return self.primary()

    def primary(self):
        if self.accept("("):
            e = self.expr()
            self.expect(")")
            return e
        if self.peek() in ("$signed", "$unsigned"):
            name = self.next()[1]
            self.expect("(")
            e = self.expr()
            self.expect(")")
            return _Cast(e, signed=name == "$signed")
        if self.accept("{"):
            parts = [self.expr()]
            while self.accept(","):
                parts.append(self.expr())
            self.expect("}")
            return _Concat(parts)
        kind, text = self.next()
        if kind in ("num", "sized"):
            return _parse_literal(kind, text)
        if kind == "id" and text not in _KEYWORDS:
            if self.accept("("):
                arg = self.expr()
                self.expect(")")
                return _Call(text, arg)
            if self.peek() == "[":
                self.next()
                msb = self.integer()
                self.expect(":")
                lsb = self.integer()
                self.expect("]")
                if lsb < 0 or msb < lsb:
                    raise RtlSimError(f"bad part-select {text}[{msb}:{lsb}]")
                return _Slice(text, msb, lsb)
            return _Id(text)
        raise RtlSimError(f"unexpected token {text!r} in expression")

    # ---------------------------------------------------------------- module
    def function(self) -> _Func:
        self.accept("automatic")
        signed = self.accept("signed")
        n = self.range_width()
        fname = self.ident()
        self.expect(";")
        self.expect("input")
        arg_signed = self.accept("signed")
        if arg_signed:
            raise RtlSimError("signed function inputs are out of subset")
        m = self.range_width()
        self.ident()                    # argument name (unused: case target)
        self.expect(";")
        self.expect("begin")
        self.expect("case")
        self.expect("(")
        self.ident()
        self.expect(")")
        if m > 22:
            raise RtlSimError(f"case table 2^{m} too large to materialize")
        table = np.zeros(1 << m, np.uint64)
        seen = np.zeros(1 << m, bool)
        default = 0
        while not self.accept("endcase"):
            if self.accept("default"):
                self.expect(":")
                lhs = self.ident()
                self.expect("=")
                kind, text = self.next()
                default = int(_parse_literal(kind, text).bits)
                self.expect(";")
            else:
                kind, text = self.next()
                entry = _parse_literal(kind, text)
                self.expect(":")
                lhs = self.ident()
                self.expect("=")
                k2, t2 = self.next()
                val = _parse_literal(k2, t2)
                self.expect(";")
                idx = int(entry.bits)
                if idx >= (1 << m):
                    raise RtlSimError(f"case entry {idx} exceeds input width {m}")
                table[idx] = np.uint64(val.bits & int(_mask(n)))
                seen[idx] = True
            if lhs != fname:
                raise RtlSimError(
                    f"case assigns {lhs!r}, expected function name {fname!r}")
        table[~seen] = np.uint64(default & int(_mask(n)))
        self.expect("end")
        self.expect("endfunction")
        return _Func(name=fname, n=n, signed=signed, m=m, table=table)


# --------------------------------------------------------------------------- #
# the module evaluator
# --------------------------------------------------------------------------- #
class RtlModule:
    """A parsed combinational module, evaluated with Verilog semantics."""

    def __init__(self, name: str, ports: List[_Port], wires: List[_Wire],
                 functions: Dict[str, _Func], assigns: Dict[str, object]):
        self.name = name
        self.ports = ports
        self.wires = wires
        self.functions = functions
        self.assigns = assigns
        self._decls: Dict[str, Tuple[int, bool]] = {}
        for p in ports:
            self._decls[p.name] = (p.width, p.signed)
        for w in wires:
            if w.name in self._decls:
                raise RtlSimError(f"duplicate declaration {w.name!r}")
            self._decls[w.name] = (w.width, w.signed)
        self._shapes: Dict[int, Tuple[int, bool]] = {}

    # ------------------------------------------------------------------ parse
    @classmethod
    def parse(cls, src: str) -> "RtlModule":
        p = _Parser(_tokenize(src))
        p.expect("module")
        name = p.ident()
        p.expect("(")
        ports: List[_Port] = []
        while True:
            kind = p.next()[1]
            if kind not in ("input", "output"):
                raise RtlSimError(f"expected port direction, got {kind!r}")
            p.expect("wire")
            signed = p.accept("signed")
            width = p.range_width()
            ports.append(_Port(p.ident(), width, signed, kind))
            if not p.accept(","):
                break
        p.expect(")")
        p.expect(";")

        wires: List[_Wire] = []
        functions: Dict[str, _Func] = {}
        assigns: Dict[str, object] = {}
        while not p.accept("endmodule"):
            if p.accept("function"):
                fn = p.function()
                functions[fn.name] = fn
            elif p.accept("wire"):
                signed = p.accept("signed")
                width = p.range_width()
                wname = p.ident()
                p.expect("=")
                expr = p.expr()
                p.expect(";")
                wires.append(_Wire(wname, width, signed, expr))
            elif p.accept("assign"):
                out = p.ident()
                p.expect("=")
                assigns[out] = p.expr()
                p.expect(";")
            else:
                raise RtlSimError(f"unexpected token {p.peek()!r} in module body")
        return cls(name, ports, wires, functions, assigns)

    # ------------------------------------------------------- shape resolution
    def _shape(self, node) -> Tuple[int, bool]:
        """Self-determined (width, signedness) of an expression."""
        cached = self._shapes.get(id(node))
        if cached is not None:
            return cached
        if isinstance(node, _Num):
            s = (node.width, node.signed)
        elif isinstance(node, _Id):
            if node.name not in self._decls:
                raise RtlSimError(f"reference to undeclared wire {node.name!r}")
            s = self._decls[node.name]
        elif isinstance(node, _Slice):
            if node.name not in self._decls:
                raise RtlSimError(f"part-select of undeclared wire {node.name!r}")
            decl_w, _ = self._decls[node.name]
            if node.msb >= decl_w:
                # IEEE semantics: out-of-range select reads x — refuse
                raise RtlSimError(
                    f"part-select {node.name}[{node.msb}:{node.lsb}] exceeds "
                    f"declared width {decl_w} (would read x bits)")
            s = (node.msb - node.lsb + 1, False)
        elif isinstance(node, _Concat):
            s = (sum(self._shape(x)[0] for x in node.parts), False)
        elif isinstance(node, _Cast):
            s = (self._shape(node.a)[0], node.signed)
        elif isinstance(node, _Unary):
            s = self._shape(node.a)
        elif isinstance(node, _Bin):
            wa, sa = self._shape(node.a)
            wb, sb = self._shape(node.b)
            if node.op in ("+", "-", "*", "&", "|", "^"):
                s = (max(wa, wb), sa and sb)
            elif node.op in ("<<", ">>", "<<<", ">>>"):
                s = (wa, sa)            # amount is self-determined
            else:                       # comparison
                s = (1, False)
        elif isinstance(node, _Tern):
            wa, sa = self._shape(node.a)
            wb, sb = self._shape(node.b)
            s = (max(wa, wb), sa and sb)
        elif isinstance(node, _Call):
            fn = self.functions.get(node.name)
            if fn is None:
                raise RtlSimError(f"call to unknown function {node.name!r}")
            s = (fn.n, fn.signed)
        else:
            raise RtlSimError(f"unknown AST node {node!r}")
        if s[0] > 64:
            raise RtlSimError(f"expression width {s[0]} exceeds 64 bits")
        self._shapes[id(node)] = s
        return s

    # ------------------------------------------------------------- evaluation
    def _eval(self, node, W: int, S: bool, env: Dict[str, np.ndarray]):
        """Bit pattern of ``node`` evaluated in a (W, S) context.

        Context-determined operands are recursively evaluated at (W, S);
        self-determined positions (shift amounts, comparison sub-contexts,
        ternary conditions, concat parts, cast and call arguments) start
        fresh contexts of their own — the LRM sizing algorithm.
        """
        if isinstance(node, _Num):
            return _extend(_u64(node.bits), node.width, W, S and node.signed)
        if isinstance(node, _Id):
            w, sg = self._shape(node)
            return _extend(env[node.name], w, W, S and sg)
        if isinstance(node, _Slice):
            self._shape(node)           # validates the range
            w = node.msb - node.lsb + 1
            v = (env[node.name] >> _u64(node.lsb)) & _mask(w)
            return v                    # unsigned: zero bits above w already
        if isinstance(node, _Concat):
            total = self._shape(node)[0]
            acc = None
            for part in node.parts:
                pw, ps = self._shape(part)
                bits = self._eval(part, pw, ps, env)
                # total <= 64 (checked in _shape), so every part after the
                # first leaves headroom for the accumulated shift
                acc = bits if acc is None else ((acc << _u64(pw)) | bits)
            return _extend(acc & _mask(total), total, W, False)
        if isinstance(node, _Cast):
            cw, cs = self._shape(node.a)
            bits = self._eval(node.a, cw, cs, env)
            return _extend(bits, cw, W, S and node.signed)
        if isinstance(node, _Unary):
            v = self._eval(node.a, W, S, env)
            return (_u64(0) - v) & _mask(W)
        if isinstance(node, _Tern):
            cw, cs = self._shape(node.c)
            cond = self._eval(node.c, cw, cs, env) != 0
            a = self._eval(node.a, W, S, env)
            b = self._eval(node.b, W, S, env)
            return np.where(cond, a, b)
        if isinstance(node, _Call):
            fn = self.functions[node.name]
            aw, asg = self._shape(node.arg)
            bits = self._eval(node.arg, aw, asg, env)
            idx = _extend(bits, aw, fn.m, asg)      # arg coercion = assignment
            idx = np.asarray(idx, np.uint64).astype(np.int64)
            out = fn.table[idx]
            return _extend(out, fn.n, W, S and fn.signed)
        if isinstance(node, _Bin):
            op = node.op
            if op in ("+", "-", "*", "&", "|", "^"):
                a = self._eval(node.a, W, S, env)
                b = self._eval(node.b, W, S, env)
                if op == "+":
                    v = a + b
                elif op == "-":
                    v = a - b
                elif op == "*":
                    v = a * b
                elif op == "&":
                    v = a & b
                elif op == "|":
                    v = a | b
                else:
                    v = a ^ b
                return v & _mask(W)
            if op in ("<<", ">>", "<<<", ">>>"):
                left = self._eval(node.a, W, S, env)
                amt = self._static_shift(node.b, env)
                if op in ("<<", "<<<"):
                    if amt >= 64:
                        return np.zeros_like(left)
                    return (left << _u64(amt)) & _mask(W)
                if op == ">>>" and S:
                    iv = _as_int(left, W, True)
                    iv = np.asarray(iv, np.int64) >> np.int64(min(amt, 63))
                    return iv.view(np.uint64) & _mask(W)
                if amt >= 64:
                    return np.zeros_like(left)
                return (left & _mask(W)) >> _u64(amt)
            # comparison: its own sizing context between the two operands
            wa, sa = self._shape(node.a)
            wb, sb = self._shape(node.b)
            wc, sc = max(wa, wb), sa and sb
            a = _as_int(self._eval(node.a, wc, sc, env), wc, sc)
            b = _as_int(self._eval(node.b, wc, sc, env), wc, sc)
            cond = {">": a > b, "<": a < b, ">=": a >= b, "<=": a <= b,
                    "==": a == b, "!=": a != b}[op]
            return np.where(cond, _u64(1), _u64(0))
        raise RtlSimError(f"cannot evaluate node {node!r}")

    def _static_shift(self, node, env) -> int:
        """Shift amounts must be compile-time constants in the subset."""
        if isinstance(node, _Num):
            return int(node.bits)
        raise RtlSimError("non-constant shift amounts are out of subset")

    def _assign_context(self, lhs_width: int, expr) -> Tuple[int, bool]:
        w, s = self._shape(expr)
        W = max(lhs_width, w)
        if W > 64:
            raise RtlSimError(f"assignment context width {W} exceeds 64 bits")
        return W, s

    # -------------------------------------------------------------------- run
    @property
    def input_ports(self) -> List[_Port]:
        return [p for p in self.ports if p.direction == "input"]

    @property
    def output_ports(self) -> List[_Port]:
        return [p for p in self.ports if p.direction == "output"]

    @property
    def n_wires(self) -> int:
        return len(self.wires)

    def run(self, x_codes: np.ndarray) -> np.ndarray:
        """Evaluate the module over a batch of input codes.

        Same contract as ``DaisProgram.run``: ``(B, n_inputs)`` int64 codes
        in, ``(B, n_outputs)`` int64 codes out, ports in declaration order.
        """
        x = np.ascontiguousarray(np.asarray(x_codes, np.int64))
        if x.ndim == 1:
            x = x[None]
        ins = self.input_ports
        if x.shape[1] != len(ins):
            raise RtlSimError(
                f"module has {len(ins)} inputs, got {x.shape[1]} columns")
        env: Dict[str, np.ndarray] = {}
        for k, p in enumerate(ins):
            env[p.name] = x[:, k].copy().view(np.uint64) & _mask(p.width)
        for w in self.wires:
            W, S = self._assign_context(w.width, w.expr)
            env[w.name] = np.asarray(
                self._eval(w.expr, W, S, env), np.uint64) & _mask(w.width)
        outs = []
        for p in self.output_ports:
            expr = self.assigns.get(p.name)
            if expr is None:
                raise RtlSimError(f"output port {p.name!r} is never assigned")
            W, S = self._assign_context(p.width, expr)
            bits = np.asarray(
                self._eval(expr, W, S, env), np.uint64) & _mask(p.width)
            v = _as_int(bits, p.width, p.signed)
            outs.append(np.asarray(v).view(np.int64) if not p.signed else v)
        return np.stack([np.broadcast_to(o, x.shape[:1]) for o in outs],
                        axis=-1).astype(np.int64)
