"""Graph lowering to DAIS, port of ``repro.core.lower``.

A :class:`ModelGraph` is a chain of layer modules and structural ops over a
quantized input.  The graph state between nodes is an integer ndarray of SSA
register ids shaped like the activation tensor, so structural ops
(``Flatten``, ``ReLU``, ``WindowSum``) are pure index manipulation.  A
per-node-type registry (``@register_lowering``) maps each node type to the
function that emits its instructions; every (layer, site) records a
:class:`~repro_torch.core.dais.Segment`, which the serving engine uses to
recover the layer structure from the flat SSA list.

The port's layers carry their own parameters, so :func:`lower` takes the
graph alone.  This slice registers ``LUTDense`` and the structural ops; the
HGQ and LUT-Conv lowerings wait for the slices that port those layers, and
dead-cell elimination (``optimize=True`` in the reference) waits with
``core/opt.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.analysis import verify_program
from repro_torch.core.dais import DaisProgram, Reg, Segment, _tree_add
from repro_torch.core.lut_layers import LUTDense
from repro_torch.core.tables import LayerTables, extract_tables


@dataclasses.dataclass(frozen=True)
class GraphInput:
    """Input tensor spec: per-example shape (channels-last) and its grid."""

    shape: Tuple[int, ...]
    f: int
    i: int
    signed: bool = True


@dataclasses.dataclass(frozen=True)
class Flatten:
    """Collapse all spatial axes into the channel axis (site-major order)."""


@dataclasses.dataclass(frozen=True)
class ReLU:
    """Standalone relu on integer codes: clamp-at-zero saturating requant."""


@dataclasses.dataclass(frozen=True)
class WindowSum:
    """Per-channel sum over every spatial site (window-count accumulation)."""


@dataclasses.dataclass
class ModelGraph:
    """A chain of layer nodes / structural ops over a quantized input."""

    input: GraphInput
    nodes: List[object]


_LOWERINGS: Dict[type, Callable] = {}


def register_lowering(*node_types: type):
    """Register ``fn(ctx, node, regs) -> regs`` as the lowering of a type."""
    def deco(fn):
        for t in node_types:
            _LOWERINGS[t] = fn
        return fn
    return deco


@dataclasses.dataclass
class _Ctx:
    prog: DaisProgram
    lid: int = 0


def lower(graph: ModelGraph) -> DaisProgram:
    """Lower a :class:`ModelGraph` to a verified DAIS program.

    The float input is assumed pre-quantized to the input grid; each layer's
    quantizers govern all internal grids from there on.
    """
    gi = graph.input
    prog = DaisProgram()
    n_in = int(np.prod(gi.shape))
    prog.input_f = [gi.f] * n_in
    prog.input_signed = [gi.signed] * n_in
    w = gi.f + gi.i + (1 if gi.signed else 0)
    regs = np.asarray(
        [prog.emit("IN", (k,), Reg(gi.f, w, gi.signed)) for k in range(n_in)],
        np.int64).reshape(gi.shape)

    ctx = _Ctx(prog)
    for lid, node in enumerate(graph.nodes):
        fn = _LOWERINGS.get(type(node))
        if fn is None:
            raise TypeError(f"no lowering registered for {type(node)}; "
                            f"add one with @register_lowering")
        ctx.lid = lid
        regs = fn(ctx, node, regs)

    prog.outputs = [int(r) for r in np.asarray(regs).reshape(-1)]
    prog.output_f = [prog.instrs[r].reg.f for r in prog.outputs]
    # the IR boundary gate: a broken lowering fails here with diagnostics
    verify_program(prog)
    return prog


def compile_sequential(layers: Sequence[LUTDense], input_f: int, input_i: int,
                       input_signed: bool = True) -> DaisProgram:
    """Lower a flat stack of dense layers: the trivial chain ModelGraph."""
    graph = ModelGraph(
        input=GraphInput(shape=(layers[0].c_in,), f=input_f, i=input_i,
                         signed=input_signed),
        nodes=list(layers))
    return lower(graph)


# --------------------------------------------------------------------------- #
# LUT layers: tables extracted once, instantiated per site
# --------------------------------------------------------------------------- #
def _emit_lut_site(prog: DaisProgram, lid: int, t: LayerTables,
                   in_regs: List[int]) -> List[int]:
    """One site of a LUT layer against the *shared* tables ``t``."""
    F = t.common_f_out()
    out_regs: List[int] = []
    for i in range(t.c_out):
        terms: List[int] = []
        for j in range(t.c_in):
            m = int(t.in_width[j, i])
            n = int(t.out_width[j, i])
            if m <= 0 or n <= 0:
                continue  # pruned cell
            src = in_regs[j]
            rq = prog.emit(
                "REQUANT",
                (src, int(t.f_in[j, i]), int(t.i_in[j, i]), True, "WRAP",
                 prog.instrs[src].reg.f),
                Reg(int(t.f_in[j, i]), m, True))
            lu = prog.emit("LLUT", (rq, lid, j, i),
                           Reg(int(t.f_out[j, i]), n, True))
            if int(t.f_out[j, i]) != F:
                lu = prog.emit("CMUL", (lu, 1 << (F - int(t.f_out[j, i])), 0),
                               Reg(F, n + F - int(t.f_out[j, i]), True))
            terms.append(lu)
        if not terms:  # fully pruned output
            out_regs.append(prog.emit("CONST", (0,), Reg(F, 1, True)))
        else:
            out_regs.append(_tree_add(prog, terms, F))
    return out_regs


@register_lowering(LUTDense)
def _lower_lut_dense(ctx: _Ctx, layer: LUTDense, regs) -> np.ndarray:
    # time-distributed over any leading spatial axes: one shared table set,
    # one segment per site
    sites = regs.reshape(-1, regs.shape[-1])
    if sites.shape[1] != layer.c_in:
        raise ValueError(f"LUTDense expects {layer.c_in} channels, "
                         f"got state shape {regs.shape}")
    t = extract_tables(layer)
    ctx.prog.tables[ctx.lid] = t
    n_sites = sites.shape[0]
    outs = np.empty((n_sites, t.c_out), np.int64)
    for s in range(n_sites):
        in_regs = [int(r) for r in sites[s]]
        out_regs = _emit_lut_site(ctx.prog, ctx.lid, t, in_regs)
        ctx.prog.segments.append(Segment(
            kind="lut", layer_id=ctx.lid, in_regs=tuple(in_regs),
            out_regs=tuple(out_regs), site=s, n_sites=n_sites))
        outs[s] = out_regs
    return outs.reshape(regs.shape[:-1] + (layer.c_out,))


# --------------------------------------------------------------------------- #
# structural ops
# --------------------------------------------------------------------------- #
@register_lowering(Flatten)
def _lower_flatten(ctx: _Ctx, node, regs) -> np.ndarray:
    return regs.reshape(-1)


@register_lowering(ReLU)
def _lower_relu(ctx: _Ctx, node, regs) -> np.ndarray:
    flat = regs.reshape(-1)
    outs = np.empty(flat.shape, np.int64)
    for s, r in enumerate(flat):
        r = int(r)
        reg = ctx.prog.instrs[r].reg
        f = reg.f
        out = ctx.prog.emit(
            "REQUANT", (r, f, max(reg.width - f, 1), False, "SAT", f),
            Reg(f, reg.width, False))
        ctx.prog.segments.append(Segment(
            kind="relu", layer_id=ctx.lid, in_regs=(r,), out_regs=(out,),
            site=s, n_sites=flat.size))
        outs[s] = out
    return outs.reshape(regs.shape)


@register_lowering(WindowSum)
def _lower_window_sum(ctx: _Ctx, node, regs) -> np.ndarray:
    if regs.ndim < 2:
        raise ValueError(f"WindowSum needs a spatial axis, got {regs.shape}")
    sites = regs.reshape(-1, regs.shape[-1])        # (S, C)
    c = sites.shape[1]
    outs = np.empty((c,), np.int64)
    for ch in range(c):
        in_regs = [int(r) for r in sites[:, ch]]
        f = max(ctx.prog.instrs[r].reg.f for r in in_regs)
        acc = _tree_add(ctx.prog, list(in_regs), f)
        ctx.prog.segments.append(Segment(
            kind="acc", layer_id=ctx.lid, in_regs=tuple(in_regs),
            out_regs=(acc,), site=ch, n_sites=c))
        outs[ch] = acc
    return outs
