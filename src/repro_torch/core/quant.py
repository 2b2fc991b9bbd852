"""HGQ fixed-point quantizers (port of ``repro.core.quant``).

A quantized value with sign bit ``k`` (0/1), integer bits ``i`` and
fractional bits ``f`` lives on the grid ``2**-f * Z`` restricted to
``[-k * 2**i, 2**i - 2**-f]``; total physical width ``b = k + i + f``.
WRAP wraps out-of-range values modulo the grid span (dropping carry bits in
hardware), SAT clamps them, and an element whose width is ``<= 0`` is pruned
to exactly 0.

Training keeps the bit-widths trainable: they are clipped (:func:`clip_tie`,
whose gradient splits ties at a bound as ``jnp.clip``'s does) and rounded
with a straight-through estimator (:class:`RoundSTE`), and
:class:`FakeQuant` carries the analytic surrogate gradients of ``_fq_bwd``
for ``x``, ``f`` and ``i``.  On a CUDA tensor the forward of
:class:`FakeQuant` is kernel B1 (``kernels/fake_quant.py``); its backward is
plain PyTorch, as the reference has no kernel for it.
:func:`quantize_to_int` / :func:`int_to_float` are the bit-exact numpy path
shared by truth-table extraction and the DAIS interpreter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

LOG2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of one HGQ quantizer."""

    granularity: str = "element"     # element | channel | tensor
    signed: bool = True
    overflow: str = "SAT"            # SAT | WRAP
    init_f: float = 6.0              # initial fractional bits
    init_i: float = 2.0              # initial integer bits (excl. sign)
    trainable: bool = True
    min_f: float = -8.0
    min_i: float = -8.0
    max_f: float = 12.0
    max_i: float = 12.0

    def param_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        if self.granularity == "element":
            return tuple(shape)
        if self.granularity == "channel":
            return (shape[-1],) if shape else ()
        if self.granularity == "tensor":
            return ()
        raise ValueError(f"unknown granularity {self.granularity!r}")


def init_quantizer(cfg: QuantConfig, shape: Tuple[int, ...], *,
                   device="cuda") -> dict:
    """The ``{"f", "i"}`` bit-width tensors of a quantizer over ``shape``."""
    ps = cfg.param_shape(shape)
    return {
        "f": torch.full(ps, cfg.init_f, dtype=torch.float32, device=device),
        "i": torch.full(ps, cfg.init_i, dtype=torch.float32, device=device),
    }


def pow2(e: torch.Tensor) -> torch.Tensor:
    """``2**e`` for float32 ``e``, exact where ``e`` is an integer (0 below
    2**-149, inf above 2**127), ``torch.exp2`` elsewhere.

    ``torch.exp2`` is exact at every integer on the CPU, but on the H100 it
    misses 2**-127 (ROADMAP C7), so the plain quantizer builds the bits:
    2**e = 2**h * 2**(e - h) with h = floor(e / 2), both halves normal
    floats made from their exponent bits, and the product rounds once."""
    k = torch.clamp(e, -252.0, 254.0)
    h = torch.floor(k * 0.5)
    halves = torch.stack((h, k - h))                  # each in [-126, 127]
    bits = (halves * 8388608.0 + 1065353216.0).to(torch.int32).view(torch.float32)
    return torch.where(e == torch.round(e), bits[0] * bits[1], torch.exp2(e))


def _fq_eval(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
             signed: bool, overflow: str) -> torch.Tensor:
    scale = pow2(-f)
    hi = pow2(i) - scale
    lo = -pow2(i) if signed else torch.zeros_like(hi)
    q = torch.round(x / scale) * scale            # round half to even
    if overflow == "SAT":
        q = torch.minimum(torch.maximum(q, lo), hi)
    else:  # WRAP: a floor-mod like jnp.mod, hence remainder and not fmod
        span = hi - lo + scale
        q = lo + torch.remainder(q - lo, span)
    width = i + f + (1.0 if signed else 0.0)
    return torch.where(width > 0.0, q, torch.zeros_like(q))


class _ClipTie(torch.autograd.Function):
    """``min(max(x, lo), hi)`` whose gradient is 1 inside, 0 outside and 1/2
    exactly on a bound, as ``jax.grad`` of ``jnp.clip`` / ``jnp.maximum``
    gives it (``torch.clamp`` gives 1 there)."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        y = x
        if lo is not None:
            y = torch.clamp(y, min=lo)
        if hi is not None:
            y = torch.clamp(y, max=hi)
        return y

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = torch.ones_like(x)
        if ctx.lo is not None:
            w = torch.where(x < ctx.lo, 0.0, torch.where(x == ctx.lo, 0.5, w))
        if ctx.hi is not None:
            w = torch.where(x > ctx.hi, 0.0, torch.where(x == ctx.hi, 0.5, w))
        return g * w, None, None


def clip_tie(x: torch.Tensor, lo: Optional[float], hi: Optional[float]) -> torch.Tensor:
    """Clip with the reference's tie-splitting gradient (see :class:`_ClipTie`)."""
    return _ClipTie.apply(x, lo, hi)


class RoundSTE(torch.autograd.Function):
    """``torch.round`` (half to even) forward, identity backward.

    Written as a Function because ``x + (round(x) - x).detach()`` does not
    give back ``round(x)`` exactly for every float."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    return RoundSTE.apply(x)


def _fq_forward(x, f, i, signed, overflow):
    """Kernel B1 on a CUDA tensor, :func:`_fq_eval` on a CPU tensor, and on a
    ``meta`` tensor (the dry-run) the output's shape and nothing launched.
    B1 reads a contiguous ``x`` or one expanded along its last axis in place
    (``LUTDense``'s input quantizer); any other layout is copied first."""
    from repro_torch.kernels.fake_quant import fake_quant_fused, x_layout

    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    if x_layout(x) is None:
        x = x.contiguous()
    return fake_quant_fused(x, f, i, signed=signed, overflow=overflow)


def _fq_bwd(x, f, i, signed: bool, overflow: str, g):
    """Surrogate VJP of the fake-quantizer (``repro.core.quant._fq_bwd``),
    on the exact powers of two of the forward (:func:`pow2`)."""
    scale, top = pow2(torch.stack(torch.broadcast_tensors(-f, i)))
    rounded = torch.round(x / scale) * scale
    alive = i + f + (1.0 if signed else 0.0) > 0.0
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    if overflow == "SAT":
        # STE inside the representable range, zero outside
        clipped_hi = rounded > top - scale
        clipped_lo = rounded < (-top if signed else 0.0)
        dx = torch.where(alive & ~(clipped_hi | clipped_lo), g, zero)
        df = torch.where(clipped_hi, LOG2 * scale, LOG2 * (x - rounded))
        df = torch.where(clipped_lo, zero, df)
        di = torch.where(clipped_lo, -LOG2 * top,
                         torch.where(clipped_hi, LOG2 * top, zero))
    else:  # WRAP: a wrap is invisible to the loss surface, so no di
        dx = torch.where(alive, g, zero)
        df = LOG2 * (x - rounded)
        di = zero
    df = torch.where(alive, df * g, zero)
    di = torch.where(alive, di * g, zero)
    return dx, _reduce_to_shape(df, f.shape), _reduce_to_shape(di, i.shape)


def _reduce_to_shape(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a broadcast gradient back to its parameter's ``shape``."""
    shape = tuple(shape)
    if tuple(g.shape) == shape:
        return g
    extra = g.dim() - len(shape)
    if extra > 0:
        g = torch.sum(g, dim=tuple(range(extra)))
    axes = tuple(a for a, (gs, ss) in enumerate(zip(g.shape, shape)) if gs != ss)
    if axes:
        g = torch.sum(g, dim=axes, keepdim=True)
    return g.reshape(shape)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _width_placements(placements, ndim: int, w_shape):
    """The placements widths of ``w_shape`` take beside a DTensor ``x`` of
    ``ndim`` dims under ``placements``: sharded where ``x`` is sharded on a
    trailing dim the widths do not broadcast along, else replicated."""
    from torch.distributed.tensor import Replicate, Shard

    w_shape = tuple(w_shape)
    off = ndim - len(w_shape)
    return [Shard(p.dim - off) if isinstance(p, Shard) and p.dim - off >= 0
            and w_shape[p.dim - off] != 1 else Replicate() for p in placements]


def _local_shards(x, f, i):
    """``(x_dt, x_local, f_local, i_local)`` for a call on DTensors.

    ``x_dt`` is ``x`` with any pending reduction (``Partial``) made
    ``Replicate`` (the quantizer is not linear), and the widths are placed
    by :func:`_width_placements` beside it (a plain width is held whole by
    every rank and sliced).  DTensor widths need a DTensor ``x``."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    if not _is_dtensor(x):
        raise ValueError("fake-quant: DTensor widths need a DTensor x")
    mesh = x.device_mesh
    place = [Replicate() if p.is_partial() else p for p in x.placements]
    if place != list(x.placements):
        x = x.redistribute(mesh, place)
    local = []
    for w in (f, i):
        if not _is_dtensor(w):
            w = torch.as_tensor(w, dtype=torch.float32, device=x.to_local().device)
        wp = _width_placements(x.placements, x.dim(), w.shape)
        if not _is_dtensor(w):
            w = distribute_tensor(w, mesh, wp, src_data_rank=None)
        elif list(w.placements) != wp:
            w = w.redistribute(mesh, wp)
        local.append(w.to_local())
    return x, x.to_local(), local[0], local[1]


class _Placed:
    """A DTensor's mesh, placements and shape, without its data."""

    def __init__(self, x):
        self.mesh, self.placements, self.shape = x.device_mesh, tuple(x.placements), x.shape

    def from_local(self, out: torch.Tensor):
        """``out``, a contiguous local shard, as a DTensor placed so."""
        from torch.distributed.tensor import DTensor

        stride = torch.empty(self.shape, device="meta").stride()
        return DTensor.from_local(out, self.mesh, self.placements, run_check=False,
                                  shape=self.shape, stride=stride)


class FakeQuant(torch.autograd.Function):
    """Fake-quant with integer-valued ``(f, i)`` tensors and the analytic
    surrogate VJP (``repro.core.quant._fq_core``).  ``f``/``i`` broadcast
    against ``x``; their gradients are reduced back to their own shapes.

    On DTensors both passes run on the local shards (:func:`_local_shards`):
    the forward is one B1 call on the shard, the backward the surrogate on
    the shard, and a width's gradient is ``Partial`` (summed over ranks when
    it is read) on each mesh dim where ``x`` is sharded and the width is
    not.  The backward keeps ``x``'s placement (:class:`_Placed`), not the
    DTensor: a tensor held on ``ctx`` outside ``save_for_backward`` outlives
    a checkpointed layer's forward."""

    @staticmethod
    def forward(ctx, x, f, i, signed: bool, overflow: str):
        ctx.signed, ctx.overflow = signed, overflow
        ctx.dt = None
        if any(_is_dtensor(t) for t in (x, f, i)):
            w_dt = [_is_dtensor(w) for w in (f, i)]
            xd, x, f, i = _local_shards(x, f, i)
            ctx.dt = (_Placed(xd), w_dt)
        ctx.save_for_backward(x, f, i)
        out = _fq_forward(x, f, i, signed, overflow)
        return out if ctx.dt is None else ctx.dt[0].from_local(out)

    @staticmethod
    def backward(ctx, g):
        x, f, i = ctx.saved_tensors
        if ctx.dt is None:
            return (*_fq_bwd(x, f, i, ctx.signed, ctx.overflow, g), None, None)
        return (*_fq_bwd_shards(x, f, i, ctx, g), None, None)


def _fq_bwd_shards(x, f, i, ctx, g):
    """:func:`_fq_bwd` on the local shards of a DTensor call, its gradients
    placed back as DTensors (each width's as the width came in)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    xp, w_dt = ctx.dt
    if isinstance(g, DTensor):
        if tuple(g.placements) != xp.placements:
            g = g.redistribute(xp.mesh, xp.placements)
        g = g.to_local()
    dx, df, di = _fq_bwd(x, f, i, ctx.signed, ctx.overflow, g)
    out = [xp.from_local(dx.contiguous())]
    for dw, dt in zip((df, di), w_dt):
        wp = _width_placements(xp.placements, len(xp.shape), dw.shape)
        place = [Partial() if p.is_shard() and not q.is_shard() else q
                 for p, q in zip(xp.placements, wp)]
        d = DTensor.from_local(dw, xp.mesh, place, run_check=False)
        out.append(d if dt else d.redistribute(xp.mesh, [Replicate()] * len(place)).to_local())
    return out


def fq_surrogate(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor, *,
                 signed: bool = True, overflow: str = "SAT") -> torch.Tensor:
    """Fake-quant with integer-valued ``(f, i)`` tensors and the surrogate
    VJP attached: the building block of the einsum train path and of
    ``kernels/ref.lut_dense_train_ref``."""
    return FakeQuant.apply(x, f, i, signed, overflow)


def ste_bits(qp: dict, cfg: QuantConfig, *, train: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped and STE-rounded ``(f, i)``, as :func:`fake_quant` derives them
    from the continuous parameters; ``train=False`` stops their gradients
    (frozen deployment widths)."""
    f = round_ste(clip_tie(qp["f"], cfg.min_f, cfg.max_f))
    i = round_ste(clip_tie(qp["i"], cfg.min_i, cfg.max_i))
    if not train:
        f, i = f.detach(), i.detach()
    return f, i


def fake_quant(qp: dict, x: torch.Tensor, cfg: QuantConfig, *,
               train: bool = True) -> torch.Tensor:
    """Quantize ``x`` on the fixed-point grid described by ``qp``.

    The forward is always a true fixed-point projection; with ``train`` the
    gradients reach the continuous bit-width parameters through the STE."""
    f, i = ste_bits(qp, cfg, train=train)
    return FakeQuant.apply(x.float(), f, i, cfg.signed, cfg.overflow).to(x.dtype)


def bitwidth(qp: dict, cfg: QuantConfig) -> torch.Tensor:
    """Effective physical bit-width per parameter element (>= 0, STE-rounded)."""
    f, i = ste_bits(qp, cfg)
    k = 1.0 if cfg.signed else 0.0
    return clip_tie(f + i + k, 0.0, None)


def int_bits(qp: dict, cfg: QuantConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Concrete (f, i) integers for deployment (numpy, host-side)."""
    f = np.clip(qp["f"].detach().cpu().numpy(), cfg.min_f, cfg.max_f)
    i = np.clip(qp["i"].detach().cpu().numpy(), cfg.min_i, cfg.max_i)
    return np.round(f).astype(np.int32), np.round(i).astype(np.int32)


def quantize_to_int(
    x: np.ndarray, f: np.ndarray, i: np.ndarray, signed: bool, overflow: str
) -> np.ndarray:
    """Project float ``x`` to the *integer code* on the (f, i) grid.

    The code is ``round(x * 2**f)`` wrapped/clipped into the representable
    integer range.  ``int_to_float(code) == fake_quant(x)`` exactly.
    """
    f = np.asarray(f, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    width = f + i + (1 if signed else 0)
    code = np.round(np.asarray(x, dtype=np.float64) * np.exp2(f)).astype(np.int64)
    n_codes = np.where(width > 0, 2 ** np.maximum(width, 0), 1)
    lo = np.where(signed, -(n_codes // 2), 0)
    hi = lo + n_codes - 1
    if overflow == "SAT":
        code = np.clip(code, lo, hi)
    else:
        code = lo + np.mod(code - lo, n_codes)
    return np.where(width > 0, code, 0)


def int_to_float(code: np.ndarray, f: np.ndarray) -> np.ndarray:
    return np.asarray(code, dtype=np.float64) * np.exp2(-np.asarray(f, dtype=np.float64))
