"""Graph lowering to DAIS, port of ``repro.core.lower``.

A :class:`ModelGraph` is a chain of layer modules and structural ops over a
quantized input.  The graph state between nodes is an integer ndarray of SSA
register ids shaped like the activation tensor, so structural ops
(``Flatten``, ``ReLU``, ``WindowSum``) are pure index manipulation.  A
per-node-type registry (``@register_lowering``) maps each node type to the
function that emits its instructions; every (layer, site) records a
:class:`~repro_torch.core.dais.Segment`, which the serving engine uses to
recover the layer structure from the flat SSA list.

Convolutions lower by sharing one :class:`~repro_torch.core.tables.LayerTables`
across all spatial sites: tables are extracted once per layer (through the
layer's ``dense`` view) and every site emits LLUT instructions against the
same ``layer_id``.  Patch extraction over register grids (``_patches_1d`` /
``_patches_2d``) is the integer-domain im2col: k-major, c-minor, SAME pads
split low side first and read a cached CONST 0 register on the source
channel's grid.  HGQ layers quantize their weight codes once per layer and
emit constant-multiply trees per site.

The port's layers carry their own parameters, so :func:`lower` takes the
graph alone.  Registered: ``LUTDense``, ``LUTConv1D``, ``LUTConv2D``,
``HGQDense``, ``HGQConv1D`` and the structural ops.  ``optimize=True`` runs
dead-cell elimination (``core/opt.py``) on the lowered program.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.analysis import verify_program
from repro_torch.core.dais import DaisProgram, Reg, Segment, _tree_add
from repro_torch.core.hgq_layers import HGQConv1D, HGQDense
from repro_torch.core.lut_layers import LUTConv1D, LUTConv2D, LUTDense, _same_pads
from repro_torch.core.quant import int_bits, quantize_to_int
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
    _pads: Dict[int, int] = dataclasses.field(default_factory=dict)

    def pad_reg(self, f: int) -> int:
        """CONST 0 register on grid ``f`` (cached): the im2col zero pad."""
        if f not in self._pads:
            self._pads[f] = self.prog.emit("CONST", (0,), Reg(f, 1, True))
        return self._pads[f]


def lower(graph: ModelGraph, *, optimize: bool = False) -> DaisProgram:
    """Lower a :class:`ModelGraph` to a verified DAIS program.

    The float input is assumed pre-quantized to the input grid; each layer's
    quantizers govern all internal grids from there on.

    ``optimize=True`` runs the dead-cell elimination pass
    (:func:`repro_torch.core.opt.eliminate_dead_cells`) on the lowered
    program: cells that β·EBOPs pruning drove to a constant truth table are
    folded out, dead chains are compacted, and shared-table rows with no
    live lookup are sliced from the tables and every site's gather.  The
    pass validates its own rewrite; serving re-gates the optimized engine
    against the unoptimized oracle (``serve/api.py``).
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
    if optimize:
        from repro_torch.core.opt import eliminate_dead_cells
        prog, _report = eliminate_dead_cells(prog)
    return prog


def compile_sequential(layers: Sequence, input_f: int, input_i: int,
                       input_signed: bool = True, *,
                       optimize: bool = False) -> DaisProgram:
    """Lower a flat stack of ``LUTDense`` / ``HGQDense`` layers: the
    trivial chain ModelGraph (``optimize`` as in :func:`lower`)."""
    graph = ModelGraph(
        input=GraphInput(shape=(layers[0].c_in,), f=input_f, i=input_i,
                         signed=input_signed),
        nodes=list(layers))
    return lower(graph, optimize=optimize)


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


def _emit_lut_sites(ctx: _Ctx, t: LayerTables, sites: np.ndarray) -> np.ndarray:
    """All sites of one LUT layer; every site shares ``tables[ctx.lid]``."""
    n_sites = sites.shape[0]
    outs = np.empty((n_sites, t.c_out), np.int64)
    for s in range(n_sites):
        in_regs = [int(r) for r in sites[s]]
        out_regs = _emit_lut_site(ctx.prog, ctx.lid, t, in_regs)
        ctx.prog.segments.append(Segment(
            kind="lut", layer_id=ctx.lid, in_regs=tuple(in_regs),
            out_regs=tuple(out_regs), site=s, n_sites=n_sites))
        outs[s] = out_regs
    return outs


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
    outs = _emit_lut_sites(ctx, t, sites)
    return outs.reshape(regs.shape[:-1] + (layer.c_out,))


@register_lowering(LUTConv1D)
def _lower_lut_conv1d(ctx: _Ctx, layer: LUTConv1D, regs) -> np.ndarray:
    if regs.ndim != 2:
        raise ValueError(f"LUTConv1D expects (T, C) state, got {regs.shape}")
    patches = _patches_1d(ctx, regs, layer.kernel, layer.stride, layer.padding)
    t = extract_tables(layer)               # conv shares its dense cell grid
    ctx.prog.tables[ctx.lid] = t
    return _emit_lut_sites(ctx, t, patches)


@register_lowering(LUTConv2D)
def _lower_lut_conv2d(ctx: _Ctx, layer: LUTConv2D, regs) -> np.ndarray:
    if regs.ndim != 3:
        raise ValueError(f"LUTConv2D expects (H, W, C) state, got {regs.shape}")
    patches = _patches_2d(ctx, regs, layer.kernel, layer.stride, layer.padding)
    oh, ow = patches.shape[:2]
    t = extract_tables(layer)
    ctx.prog.tables[ctx.lid] = t
    outs = _emit_lut_sites(ctx, t, patches.reshape(oh * ow, -1))
    return outs.reshape(oh, ow, layer.c_out)


# --------------------------------------------------------------------------- #
# patch extraction over register grids (the im2col of the integer domain)
# --------------------------------------------------------------------------- #
def _pad_rows(ctx: _Ctx, regs: np.ndarray) -> np.ndarray:
    """One row of zero-pad registers matching each channel's grid."""
    return np.asarray(
        [ctx.pad_reg(ctx.prog.instrs[int(r)].reg.f) for r in regs], np.int64)


def _patches_1d(ctx: _Ctx, regs: np.ndarray, kernel: int, stride: int,
                padding: str) -> np.ndarray:
    """(T, C) register grid -> (S, kernel*C) patch rows (k-major, c-minor),
    as ``lut_layers.im2col_1d``: SAME pads split low side first, VALID
    drops the ragged tail."""
    if padding == "SAME":
        lo, hi = _same_pads(regs.shape[0], kernel, stride)
        pad = _pad_rows(ctx, regs[0])
        regs = np.concatenate([np.tile(pad, (lo, 1)), regs,
                               np.tile(pad, (hi, 1))], axis=0)
    n_out = (regs.shape[0] - kernel) // stride + 1
    idx = np.arange(n_out)[:, None] * stride + np.arange(kernel)[None, :]
    return regs[idx].reshape(n_out, kernel * regs.shape[1])


def _patches_2d(ctx: _Ctx, regs: np.ndarray, kernel: Tuple[int, int],
                stride: Tuple[int, int], padding: str) -> np.ndarray:
    """(H, W, C) register grid -> (OH, OW, kh*kw*C) patch rows."""
    kh, kw = kernel
    sh, sw = stride
    if padding == "SAME":
        hlo, hhi = _same_pads(regs.shape[0], kh, sh)
        wlo, whi = _same_pads(regs.shape[1], kw, sw)
        pad = _pad_rows(ctx, regs[0, 0])
        h, w, _c = regs.shape
        padded = np.tile(pad, (h + hlo + hhi, w + wlo + whi, 1))
        padded[hlo:hlo + h, wlo:wlo + w] = regs
        regs = padded
    oh = (regs.shape[0] - kh) // sh + 1
    ow = (regs.shape[1] - kw) // sw + 1
    ih = np.arange(oh)[:, None] * sh + np.arange(kh)[None, :]
    iw = np.arange(ow)[:, None] * sw + np.arange(kw)[None, :]
    p = regs[ih[:, None, :, None], iw[None, :, None, :], :]
    return p.reshape(oh, ow, kh * kw * regs.shape[2])


# --------------------------------------------------------------------------- #
# HGQ layers: weight codes quantized once, constant-multiply trees per site
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class _HgqSpec:
    """Per-layer constants shared by every spatial site."""

    fa: np.ndarray               # (c_in,) activation fractional bits
    ia: np.ndarray               # (c_in,)
    fw: np.ndarray               # (c_in, c_out)
    w_codes: np.ndarray          # (c_in, c_out) integer weight codes
    grid: np.ndarray             # (c_out,) accumulation grid F_i = max_j (f_w + f_a)
    b_codes: np.ndarray          # (c_out,) biases rounded (half to even) onto F_i


def _hgq_spec(layer: HGQDense) -> _HgqSpec:
    fa, ia = int_bits(layer.q_a, layer.cfg_a)
    fw, iw = int_bits(layer.q_w, layer.cfg_w)
    fa = np.broadcast_to(fa, (layer.c_in,))
    ia = np.broadcast_to(ia, (layer.c_in,))
    # the float64 of the float32 weights, as the reference quantizes them
    w = layer.w.detach().cpu().numpy().astype(np.float64)
    w_codes = quantize_to_int(w, fw, iw, layer.cfg_w.signed, layer.cfg_w.overflow)
    bias = (layer.b.detach().cpu().numpy().astype(np.float64) if layer.use_bias
            else np.zeros(layer.c_out))
    grid = np.max(np.broadcast_to(fw + fa[:, None], (layer.c_in, layer.c_out)),
                  axis=0).astype(np.int64)
    b_codes = np.round(bias * 2.0 ** grid).astype(np.int64)
    return _HgqSpec(fa=fa, ia=ia, fw=fw, w_codes=w_codes, grid=grid,
                    b_codes=b_codes)


def hgq_bias_on_grid(layer: HGQDense) -> np.ndarray:
    """The bias the lowering adds, as floats: each output's bias rounded
    (half to even) onto its accumulation grid ``F_i = max_j (f_w[j, i] +
    f_a[j])``, as :func:`_emit_hgq_site` emits it.  A forward with this bias
    computes what the lowered program computes; with the float bias, a sum
    that lands on a rounding tie of the next quantizer may round the other
    way (ROADMAP C12)."""
    spec = _hgq_spec(layer)
    return spec.b_codes / 2.0 ** spec.grid


def _emit_hgq_site(prog: DaisProgram, layer: HGQDense, spec: _HgqSpec,
                   in_regs: List[int]) -> List[int]:
    """One site of an HGQ layer: per-element constant multiplies + adds.

    Activation grids come from ``q_a``, weights use their per-element
    (f, i).  relu lowers as a saturating REQUANT onto the unsigned grid of
    the same precision; other nonlinear activations have no plain DAIS
    form.
    """
    fa, ia, fw, w_codes = spec.fa, spec.ia, spec.fw, spec.w_codes
    cfg_a = layer.cfg_a
    ka = 1 if cfg_a.signed else 0
    act_regs = []                               # inputs quantized once per j
    for j in range(layer.c_in):
        src = in_regs[j]
        wdt = int(fa[j] + ia[j] + ka)
        act_regs.append(prog.emit(
            "REQUANT",
            (src, int(fa[j]), int(ia[j]), cfg_a.signed, cfg_a.overflow,
             prog.instrs[src].reg.f),
            Reg(int(fa[j]), max(wdt, 1), cfg_a.signed)))

    out_regs: List[int] = []
    for i in range(layer.c_out):
        F = int(spec.grid[i])
        terms: List[int] = []
        for j in range(layer.c_in):
            code = int(w_codes[j, i])
            if code == 0:
                continue
            f_prod = int(fw[j, i] + fa[j])
            wdt = prog.instrs[act_regs[j]].reg.width + \
                max(abs(code).bit_length() + 1, 1)
            r = prog.emit("CMUL", (act_regs[j], code, int(fw[j, i])),
                          Reg(f_prod, wdt, True))
            if f_prod != F:
                r = prog.emit("CMUL", (r, 1 << (F - f_prod), 0),
                              Reg(F, wdt + F - f_prod, True))
            terms.append(r)
        b_code = int(spec.b_codes[i])
        b_width = max(abs(b_code).bit_length() + 1, 1)
        if b_code != 0 or not terms:
            terms.append(prog.emit("CONST", (b_code,), Reg(F, b_width, True)))
        acc = _tree_add(prog, terms, F)
        if layer.activation == "relu":
            wdt = prog.instrs[acc].reg.width
            acc = prog.emit("REQUANT", (acc, F, max(wdt - F, 1), False, "SAT", F),
                            Reg(F, wdt, False))
        elif layer.activation is not None:
            raise NotImplementedError(
                f"activation {layer.activation!r} needs an L-LUT lowering")
        out_regs.append(acc)
    return out_regs


def _emit_hgq_sites(ctx: _Ctx, layer: HGQDense, spec: _HgqSpec,
                    sites: np.ndarray) -> np.ndarray:
    n_sites = sites.shape[0]
    outs = np.empty((n_sites, layer.c_out), np.int64)
    for s in range(n_sites):
        in_regs = [int(r) for r in sites[s]]
        out_regs = _emit_hgq_site(ctx.prog, layer, spec, in_regs)
        ctx.prog.segments.append(Segment(
            kind="hgq", layer_id=ctx.lid, in_regs=tuple(in_regs),
            out_regs=tuple(out_regs), site=s, n_sites=n_sites))
        outs[s] = out_regs
    return outs


@register_lowering(HGQDense)
def _lower_hgq_dense(ctx: _Ctx, layer: HGQDense, regs) -> np.ndarray:
    sites = regs.reshape(-1, regs.shape[-1])
    if sites.shape[1] != layer.c_in:
        raise ValueError(f"HGQDense expects {layer.c_in} channels, "
                         f"got state shape {regs.shape}")
    outs = _emit_hgq_sites(ctx, layer, _hgq_spec(layer), sites)
    return outs.reshape(regs.shape[:-1] + (layer.c_out,))


@register_lowering(HGQConv1D)
def _lower_hgq_conv1d(ctx: _Ctx, layer: HGQConv1D, regs) -> np.ndarray:
    if regs.ndim != 2:
        raise ValueError(f"HGQConv1D expects (T, C) state, got {regs.shape}")
    patches = _patches_1d(ctx, regs, layer.kernel, layer.stride, layer.padding)
    return _emit_hgq_sites(ctx, layer.dense, _hgq_spec(layer.dense), patches)


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
