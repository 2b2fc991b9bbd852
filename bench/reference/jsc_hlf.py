"""Plain PyTorch reference of the JSC-HLF LUT-Dense train step.

The HGQ-LUT objective of the paper (§III, §V-A), written out in plain
``torch`` operations with no kernel, no graph and no chunking, after the
JAX package's ``repro.core`` and ``repro.train.steps`` as they stand at
commit 1e35da467a58367bd43292fb4c37d72db1ec41f5:

* every cell ``L-LUT_{i,j}(x_j)`` is a one-hidden-layer tanh MLP between a
  signed WRAP input quantizer and a signed SAT output quantizer, each with
  trainable per-cell widths ``(f, i)`` (clipped with a tie-splitting
  gradient, rounded with a straight-through estimator);
* the quantizers' backward is HGQ's surrogate (``d/dx`` straight through
  where not clipped, ``d/df = ln2 (x - q)``, ``d/di = ±ln2 2^i`` where
  saturated);
* layer 0 has batch-norm on the cell outputs with batch statistics, whose
  moving stats are written after the optimizer;
* the loss is ``CE + β(step) · EBOPs`` with Eq. (5)'s LUT EBOPs, clipped
  to a global norm of 1 and applied by Adam with bias correction and
  cosine-restart learning rates (β at the step before the increment, the
  rate at the step after it).

It imports nothing of the program and takes only what the benchmark made:
the initial state and the batches.  ``dtype`` runs the forward and
backward in another float type (the control); Adam keeps float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

LOG2 = math.log(2.0)
LUT_X, LUT_Y = 6, 5
WIDTH_MIN, WIDTH_MAX = -8.0, 12.0      # the quantizers' clip of f and of i


class _ClipTie(torch.autograd.Function):
    """min(max(x, lo), hi); gradient 1 inside, 0 outside, 1/2 on a bound."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        y = x if lo is None else torch.clamp(x, min=lo)
        return y if hi is None else torch.clamp(y, max=hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = torch.ones_like(x)
        if ctx.lo is not None:
            w = torch.where(x < ctx.lo, 0.0, torch.where(x == ctx.lo, 0.5, w))
        if ctx.hi is not None:
            w = torch.where(x > ctx.hi, 0.0, torch.where(x == ctx.hi, 0.5, w))
        return g * w, None, None


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e for integer-valued float ``e`` in [-126, 127], exactly: the
    float32 whose exponent field is e + 127."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    extra = g.dim() - len(shape)
    if extra:
        g = g.sum(dim=tuple(range(extra)))
    return g


class _FakeQuant(torch.autograd.Function):
    """Fixed-point projection of ``x`` on the (f, i) grid with HGQ's
    surrogate gradients; ``f``, ``i`` per cell, broadcast over rows."""

    @staticmethod
    def forward(ctx, x, f, i, overflow: str):
        ctx.save_for_backward(x, f, i)
        ctx.overflow = overflow
        scale, top = pow2(-f).to(x.dtype), pow2(i).to(x.dtype)
        hi, lo = top - scale, -top
        q = torch.round(x / scale) * scale
        if overflow == "SAT":
            q = torch.minimum(torch.maximum(q, lo), hi)
        else:
            q = lo + torch.remainder(q - lo, hi - lo + scale)
        return torch.where(i + f + 1.0 > 0.0, q, torch.zeros_like(q))

    @staticmethod
    def backward(ctx, g):
        x, f, i = ctx.saved_tensors
        scale, top = pow2(-f).to(x.dtype), pow2(i).to(x.dtype)
        rounded = torch.round(x / scale) * scale
        alive = i + f + 1.0 > 0.0
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        if ctx.overflow == "SAT":
            c_hi = rounded > top - scale
            c_lo = rounded < -top
            dx = torch.where(alive & ~(c_hi | c_lo), g, zero)
            df = torch.where(c_hi, LOG2 * scale, LOG2 * (x - rounded))
            df = torch.where(c_lo, zero, df)
            di = torch.where(c_lo, -LOG2 * top, torch.where(c_hi, LOG2 * top, zero))
        else:
            dx = torch.where(alive, g, zero)
            df = LOG2 * (x - rounded)
            di = torch.zeros_like(df)
        df = torch.where(alive, df * g, zero)
        di = torch.where(alive, di * g, zero)
        return dx, _sum_to(df, f.shape), _sum_to(di, i.shape), None


def widths(p: Dict[str, torch.Tensor], q: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The STE-rounded, clipped (f, i) of quantizer ``q`` (``l0/q_in``)."""
    f = _RoundSTE.apply(_ClipTie.apply(p[f"{q}/f"], WIDTH_MIN, WIDTH_MAX))
    i = _RoundSTE.apply(_ClipTie.apply(p[f"{q}/i"], WIDTH_MIN, WIDTH_MAX))
    return f, i


def ebops_lut(p: Dict[str, torch.Tensor], layer: str) -> torch.Tensor:
    """Eq. (5) summed over a layer's cells: an m-bit input, n-bit output
    L-LUT on LUT-6s costs 2^(m-6)·n for m >= 5, (m/5)·2^(5-6)·n below."""
    fi, ii = widths(p, f"{layer}/q_in")
    fo, io = widths(p, f"{layer}/q_out")
    m = _ClipTie.apply(_ClipTie.apply(fi + ii + 1.0, 0.0, None), 0.0, None)
    n = _ClipTie.apply(_ClipTie.apply(fo + io + 1.0, 0.0, None), 0.0, None)
    wide = torch.exp2(m - LUT_X) * n
    narrow = (m / LUT_Y) * (2.0 ** (LUT_Y - LUT_X)) * n
    cost = torch.where(m >= LUT_Y, wide, narrow)
    return torch.sum(torch.where((m > 0) & (n > 0), cost, torch.zeros_like(cost)))


def lut_dense(p: Dict[str, torch.Tensor], layer: str, x: torch.Tensor, bn: Dict,
              dtype) -> torch.Tensor:
    """One LUT-Dense layer in train mode: (B, C_in) -> (B, C_out).  With
    batch-norm (``bn`` holds its moving stats) the new stats are stored in
    ``bn["new"]``."""
    c = lambda k: p[f"{layer}/{k}"].to(dtype)
    w0 = c("w0")
    xb = x[:, :, None].expand(x.shape[0], x.shape[1], w0.shape[1])
    fi, ii = widths(p, f"{layer}/q_in")
    xq = _FakeQuant.apply(xb, fi, ii, "WRAP")
    h = torch.tanh(xq[..., None] * w0 + c("b0"))
    prod = h * c("w_out")
    y = prod[..., 0]
    for k in range(1, prod.shape[-1]):
        y = y + prod[..., k]
    y = y + c("b_out")
    if bn is not None:
        mean = torch.mean(y, dim=0)
        var = torch.var(y, dim=0, correction=0)
        mom = bn["momentum"]
        bn["new"] = {"bn_mean": mom * bn["bn_mean"] + (1 - mom) * mean.detach().float(),
                     "bn_var": mom * bn["bn_var"] + (1 - mom) * var.detach().float()}
        y = (y - mean) * torch.rsqrt(var + 1e-5) * c("bn_scale") + c("bn_bias")
    fo, io = widths(p, f"{layer}/q_out")
    return torch.sum(_FakeQuant.apply(y, fo, io, "SAT"), dim=-2)


def beta(step: int, hp: Dict) -> torch.Tensor:
    """The exponential β ramp, in float32."""
    b0 = torch.tensor(hp["beta_init"], dtype=torch.float32)
    b1 = torch.tensor(hp["beta_final"], dtype=torch.float32)
    t = torch.clamp(torch.tensor(float(step)) / max(hp["nominal_steps"] - 1, 1), 0.0, 1.0)
    return torch.exp((1.0 - t) * torch.log(b0) + t * torch.log(b1))


def learning_rate(step: int, hp: Dict) -> torch.Tensor:
    """Cosine annealing with geometric warm restarts and a linear warm-up,
    in float32 (SGDR)."""
    sf = torch.tensor(float(step))
    base, period, t_mult = hp["lr"], hp["lr_first_period"], hp["lr_t_mult"]
    warm, min_frac = hp["lr_warmup"], hp["lr_min_frac"]
    tm = torch.tensor(float(t_mult))
    s = torch.clamp(sf - warm, min=0.0)
    cyc = torch.floor(torch.log2(1.0 + s * (t_mult - 1) / period) / torch.log2(tm))
    start = period * (torch.pow(tm, cyc) - 1) / (t_mult - 1)
    frac = (s - start) / (period * torch.pow(tm, cyc))
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(frac, 0.0, 1.0)))
    return base * (min_frac + (1 - min_frac) * cos) * torch.clamp(sf / max(warm, 1), 0.0, 1.0)


def loss_and_grads(p: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], cfg: Dict,
                   x: torch.Tensor, y: torch.Tensor, step: int, dtype):
    """The objective at ``step`` and its gradients; the layers' new
    batch-norm stats by state key."""
    hp, n_layers = cfg["train"], len(cfg["dims"]) - 1
    params = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    h = x.to(dtype)
    bns = {}
    for k in range(n_layers):
        bn = None
        if k in cfg["batchnorm_layers"]:
            bn = {"momentum": cfg["bn_momentum"], "bn_mean": state[f"l{k}/bn_mean"],
                  "bn_var": state[f"l{k}/bn_var"]}
        h = lut_dense(params, f"l{k}", h, bn, dtype)
        if bn is not None:
            bns.update({f"l{k}/{n}": v for n, v in bn["new"].items()})
    logp = torch.log_softmax(h.float(), dim=-1)
    ce = -torch.mean(logp.gather(-1, y.long()[:, None])[:, 0])
    ebops = sum(ebops_lut(params, f"l{k}") for k in range(n_layers))
    total = ce + beta(step, hp).to(ce.device) * ebops
    keys = list(params)
    grads = torch.autograd.grad(total, [params[k] for k in keys])
    return total.detach(), {k: g.float() for k, g in zip(keys, grads)}, bns


def adam(p: Dict, g: Dict, m: Dict, v: Dict, step: int, hp: Dict):
    """One Adam step (float32) on gradients clipped to a global norm;
    returns the new parameters and moments."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g[k])) for k in sorted(g)))
    scale = torch.clamp(hp["clip_norm"] / (norm + 1e-9), max=1.0)
    lr = learning_rate(step, hp).to(norm.device)
    b1, b2 = hp["b1"], hp["b2"]
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), float(step)).to(norm.device)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), float(step)).to(norm.device)
    new_p, new_m, new_v = {}, {}, {}
    for k in p:
        gk = g[k] * scale
        new_m[k] = b1 * m[k] + (1 - b1) * gk
        new_v[k] = b2 * v[k] + (1 - b2) * torch.square(gk)
        new_p[k] = p[k] - lr * ((new_m[k] / bc1) / (torch.sqrt(new_v[k] / bc2) + hp["eps"]))
    return new_p, new_m, new_v


def train(params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor], cfg: Dict,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], dtype=torch.float32,
          half_batch: bool = False) -> Dict:
    """Run ``len(batches)`` steps from ``params`` (trainable, float32) and
    ``state`` (batch-norm moving stats).  Returns each step's loss, the
    first step's gradient as Adam receives it (clipped) and the parameters
    and stats after the last step.  ``half_batch`` drops the second half of
    every batch (a fault the check must see)."""
    p = {k: v.float() for k, v in params.items()}
    st = {k: v.float() for k, v in state.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    hp = cfg["train"]
    losses: List[float] = []
    first = None
    for s, (x, y) in enumerate(batches):
        if half_batch:
            x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
        loss, g, bns = loss_and_grads(p, st, cfg, x, y, s, dtype)
        losses.append(float(loss))
        p, m, v = adam(p, g, m, v, s + 1, hp)
        st.update(bns)
        if first is None:
            first = {k: mk / (1 - hp["b1"]) for k, mk in m.items()}
    return {"losses": losses, "grads": first, "state": {**p, **st}}
