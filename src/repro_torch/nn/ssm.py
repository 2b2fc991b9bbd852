"""State-space sequence blocks: Mamba2 (SSD) and RWKV-6 "Finch" (port of
``repro.nn.ssm``).

Both recurrences come in two forms that compute the same function:

* the **scan** (``form="scan"``): the reference's recurrence one step at a
  time, in float32.  It is the plain version the chunked form is held
  against, and decode runs it (S = 1);
* the **chunked** form (``form="chunked"``, the default for S > 1 on every
  device): the sequence is cut into chunks of ``MAMBA_CHUNK`` /
  ``RWKV_CHUNK`` steps; inside a chunk the outputs are batched matmuls over
  a (C, C) decay matrix, and only the chunk-end states are scanned.  A
  literal scan would launch ~10 tiny ops a token a layer and keep every
  step's state for the backward.  Both take an initial state and return the
  final state and the conv / token-shift carries, as the reference does
  with ``state=``.  Every loop over time or chunks walks ``unbind``'s
  views: indexing a step out of a stacked tensor would make the backward
  write a zero tensor of the whole stack for every step.

Every exponent the chunked forms take is <= 0, so neither can overflow:

* Mamba2's decay is a scalar per head, ``log da = dt·a <= 0``, and its
  diagonal is inclusive: the pair (t, s <= t) carries ``exp(A_t - A_s)``
  with A the running sum of ``dt·a`` inside the chunk;
* RWKV-6's decay is per channel, ``log w = -exp(wlog)``, and its diagonal
  exclusive (plus the ``u`` bonus on it): the pair (t, s < t) carries
  ``exp(sum_{s<tau<t} log w_tau)`` per channel.  The factored form
  ``r·exp(+cum)``, ``k·exp(-cum)`` overflows once a chunk's summed
  log-decay passes about -88, so the port forms that pairwise (C, C, 64)
  exponent per chunk (the masked pairs set to -inf before ``exp``), at C =
  16 and in slices of at most ``RWKV_PAIR_ELEMS`` elements, each slice
  recomputed in the backward (``_ckpt``) rather than kept.

The recurrences run in float32 as the reference's do; the projections run
in the compute dtype with each weight cast where it is used; ``dt``, ``a``
and ``wlog`` are float32; the output is cast back before its norm.
``jax.nn.softplus`` is ``logaddexp(x, 0)``, and so is the port's
(``torch.logaddexp``), not ``F.softplus`` with its switch to x above 20.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.nn.attention import _proj
from repro_torch.nn.layers import rms_norm
from repro_torch.nn.params import PDef
from repro_torch.parallel.sharding import cumsum, grad_split_ready, split_ready

MAMBA_HEAD = 64   # P: channels per SSD head
RWKV_HEAD = 64    # head size of RWKV-6
CONV_K = 4
MAMBA_CHUNK = 64  # steps per chunk of the chunked SSD
RWKV_CHUNK = 16   # steps per chunk of the chunked WKV
RWKV_PAIR_ELEMS = 1 << 28  # the most pairwise (t, s, channel) terms formed at once

Tensor = torch.Tensor


def _pick(form: Optional[str], s: int) -> str:
    form = form or ("chunked" if s > 1 else "scan")
    if form not in ("scan", "chunked"):
        raise ValueError(f"form {form!r}: 'scan' or 'chunked'")
    return form


def _pad_steps(t: Tensor, pad: int) -> Tensor:
    """Zeros appended along axis 1 (the sequence)."""
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], pad, *t.shape[2:]))], dim=1)


# =============================================================== Mamba2 (SSD)
def mamba2_defs(n_layers: int, d: int, ssm_state: int, expand: int = 2) -> dict:
    L, di, n = n_layers, expand * d, ssm_state
    h = di // MAMBA_HEAD
    return {
        "w_xz": PDef((L, d, 2 * di), ("layers", "embed", "ffn")),
        "w_bc": PDef((L, d, 2 * n), ("layers", "embed", None)),
        "w_dt": PDef((L, d, h), ("layers", "embed", "ffn")),
        "dt_bias": PDef((L, h), ("layers", "ffn"), init="zeros"),
        "a_log": PDef((L, h), ("layers", "ffn"), init="zeros"),
        "d_skip": PDef((L, h), ("layers", "ffn"), init="ones"),
        "conv_w": PDef((L, CONV_K, di + 2 * n), ("layers", None, None), scale=0.5),
        "conv_b": PDef((L, di + 2 * n), ("layers", None), init="zeros"),
        "norm_y": PDef((L, di), ("layers", "ffn"), init="zeros"),
        "w_out": PDef((L, di, d), ("layers", "ffn", "embed")),
    }


def _causal_conv1d(x: Tensor, w: Tensor, b: Tensor,
                   carry: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv, kernel CONV_K.  x (B,S,C), w (K,C).

    ``carry`` is the last K-1 inputs of the previous segment (decode).  The
    K shifted multiply-adds run in x's dtype in the reference's order.
    Returns (y, new_carry)."""
    bsz, s, c = x.shape
    if carry is None:
        carry = x.new_zeros((bsz, CONV_K - 1, c))
    xp = torch.cat([carry, x], dim=1)
    y = xp[:, :s] * w[0].to(x.dtype)
    for k in range(1, CONV_K):
        y = y + xp[:, k:k + s] * w[k].to(x.dtype)
    return F.silu(y + b.to(x.dtype)), xp[:, -(CONV_K - 1):]


def ssd_scan(xh: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
             s0: Tensor) -> Tuple[Tensor, Tensor]:
    """The SSD recurrence one step at a time (the reference's ``lax.scan``):
    xh (B,S,H,P), dt (B,S,H), a (H,), bmat/cmat (B,S,N), s0 (B,H,P,N), all
    float32 -> (y (B,S,H,P), final state)."""
    state, ys = s0, []
    steps = (t.unbind(1) for t in (torch.exp(dt * a), dt, xh, bmat, cmat))
    for dat, dtt, xt, bt, ct in zip(*steps):
        state = (state * dat[..., None, None]
                 + (dtt[..., None] * xt)[..., None] * bt[:, None, None, :])
        ys.append(torch.matmul(state, ct[:, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), state


def ssd_chunked(xh: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
                s0: Tensor, chunk: int = MAMBA_CHUNK) -> Tuple[Tensor, Tensor]:
    """:func:`ssd_scan`'s function in chunks of ``chunk`` steps (the last
    padded with steps of zero ``dt``, which carry the state unchanged)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    c = min(chunk, s)
    pad = -s % c
    nc = (s + pad) // c
    def steps(t):      # (b, s, ...) -> (b, nc, c, ...)
        return split_ready(_pad_steps(t, pad), 1, nc).view(b, nc, c, *t.shape[2:])

    l = steps(dt * a).transpose(2, 3)                                        # (b,z,h,c)
    dtx = steps(dt[..., None] * xh).transpose(2, 3)
    bm = steps(bmat)
    cm = steps(cmat)
    acum = cumsum(l, -1)                                                     # A_t, inclusive
    tri = torch.ones(c, c, dtype=torch.bool, device=xh.device).tril()
    seg = torch.where(tri, acum[..., :, None] - acum[..., None, :], float("-inf"))
    gmat = torch.matmul(cm, bm.transpose(-1, -2))                            # c_t . b_s
    y = torch.matmul(torch.exp(seg) * gmat[:, :, None], dtx)                 # (b,z,h,t,p)
    to_end = torch.exp(acum[..., -1:] - acum)                                # (b,z,h,c)
    states = torch.matmul((dtx * to_end[..., None]).transpose(-1, -2), bm[:, :, None])
    decay = torch.exp(acum[..., -1])                                         # (b,z,h)
    state, prev = s0, []
    for dz, sz in zip(decay.unbind(1), states.unbind(1)):
        prev.append(state)
        state = state * dz[..., None, None] + sz
    s_prev = torch.stack(prev, dim=1)                                        # (b,z,h,p,n)
    y_in = torch.matmul(s_prev, cm[:, :, None].transpose(-1, -2)).transpose(-1, -2)
    y = y + y_in * torch.exp(acum)[..., None]
    y = grad_split_ready(y.transpose(2, 3).reshape(b, nc * c, h, p), 1, nc)[:, :s]
    return y, state


def mamba2_apply(p: dict, x: Tensor, ssm_state: int, state: Optional[dict] = None,
                 form: Optional[str] = None) -> Tuple[Tensor, Optional[dict]]:
    """x (B, S, D) -> (y, new_state).  ``state={'ssm', 'conv'}`` carries a
    segment's recurrence (decode, prefill); without it the new state is
    None.  ``form`` is ``"scan"`` or ``"chunked"`` (default: chunked for S >
    1, the scan for one step)."""
    bsz, s, _ = x.shape
    form = _pick(form, s)
    di = p["w_xz"].shape[-1] // 2
    n = ssm_state
    h = di // MAMBA_HEAD

    xz = torch.matmul(x, p["w_xz"].to(x.dtype))
    xs, z = xz[..., :di], xz[..., di:]
    bc = torch.matmul(x, p["w_bc"].to(x.dtype))
    conv_in = torch.cat([xs, bc], dim=-1)
    conv_carry = state["conv"] if state is not None else None
    conv_out, new_conv = _causal_conv1d(conv_in, p["conv_w"], p["conv_b"], conv_carry)
    xs, bmat, cmat = conv_out[..., :di], conv_out[..., di:di + n], conv_out[..., di + n:]

    dt_in = torch.matmul(x, p["w_dt"].to(x.dtype)).float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros((), device=x.device))           # (B,S,H)
    a = -torch.exp(p["a_log"].float())                                      # (H,)
    xh = split_ready(xs, -1, h).reshape(bsz, s, h, MAMBA_HEAD).float()
    s0 = (state["ssm"] if state is not None
          else torch.zeros((bsz, h, MAMBA_HEAD, n), dtype=torch.float32, device=x.device))
    run = ssd_scan if form == "scan" else ssd_chunked
    y, s_fin = run(xh, dt, a, bmat.float(), cmat.float(), s0)
    y = y + p["d_skip"].float()[:, None] * xh
    y = grad_split_ready(y.reshape(bsz, s, di), -1, h).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_y"])
    out = torch.matmul(y, p["w_out"].to(x.dtype))
    new_state = {"ssm": s_fin, "conv": new_conv} if state is not None else None
    return out, new_state


# ================================================================== RWKV-6
def rwkv6_defs(n_layers: int, d: int, d_ff: int, lora: int = 32) -> dict:
    L = n_layers
    h = d // RWKV_HEAD
    return {
        # time-mix
        "mu": PDef((L, 5, d), ("layers", None, None), init="uniform", scale=0.5),
        "w0": PDef((L, d), ("layers", None), init="zeros"),
        "w_lora_a": PDef((L, d, lora), ("layers", "embed", None), scale=0.1),
        "w_lora_b": PDef((L, lora, d), ("layers", None, None), scale=0.1),
        "wr": PDef((L, d, h, RWKV_HEAD), ("layers", "embed", "heads", None)),
        "wk": PDef((L, d, h, RWKV_HEAD), ("layers", "embed", "heads", None)),
        "wv": PDef((L, d, h, RWKV_HEAD), ("layers", "embed", "heads", None)),
        "wg": PDef((L, d, h, RWKV_HEAD), ("layers", "embed", "heads", None)),
        "u_bonus": PDef((L, h, RWKV_HEAD), ("layers", "heads", None), init="zeros"),
        "ln_x": PDef((L, h, RWKV_HEAD), ("layers", "heads", None), init="zeros"),
        "w_o": PDef((L, h, RWKV_HEAD, d), ("layers", "heads", None, "embed")),
        # channel-mix
        "mu_ff": PDef((L, 2, d), ("layers", None, None), init="uniform", scale=0.5),
        "wk_ff": PDef((L, d, d_ff), ("layers", "embed", "ffn")),
        "wv_ff": PDef((L, d_ff, d), ("layers", "ffn", "embed")),
        "wr_ff": PDef((L, d, d), ("layers", "embed", None)),
    }


def _token_shift(x: Tensor, carry: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """xx_t = x_{t-1}; carry is x_{-1} for decode segments."""
    if carry is None:
        carry = torch.zeros_like(x[:, :1])
    xx = torch.cat([carry, x[:, :-1]], dim=1)
    return xx, x[:, -1:]


def wkv_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
             s0: Tensor) -> Tuple[Tensor, Tensor]:
    """The WKV recurrence one step at a time (the reference's ``lax.scan``):
    r, k, v, w (B,S,H,D), u (H,D), s0 (B,H,D,D), float32 -> (y (B,S,H,D),
    final state)."""
    state, ys = s0, []
    for rt, kt, vt, wt in zip(*(t.unbind(1) for t in (r, k, v, w))):
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.matmul(rt[..., None, :], state + u[None, :, :, None] * kv)[..., 0, :])
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _wkv_pairs(r: Tensor, k: Tensor, v: Tensor, excl: Tensor, incl: Tensor) -> Tensor:
    """Inside each chunk, sum over s < t of (r_t . (k_s * exp(excl_t -
    incl_s))) v_s: all of (..., c, D) float32 -> (..., c, D)."""
    c = r.shape[-2]
    lower = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    expo = torch.where(lower[:, :, None], excl[..., :, None, :] - incl[..., None, :, :],
                       float("-inf"))
    att = (r[..., :, None, :] * k[..., None, :, :] * torch.exp(expo)).sum(-1)
    return torch.matmul(att, v)


def _ckpt(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def wkv_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor, s0: Tensor,
                chunk: int = RWKV_CHUNK) -> Tuple[Tensor, Tensor]:
    """:func:`wkv_scan`'s function from ``logw = log w = -exp(wlog)`` in
    chunks of ``chunk`` steps (the last padded with steps of zero k and
    log-decay, which carry the state unchanged)."""
    b, s, h, dd = r.shape
    c = min(chunk, s)
    pad = -s % c
    nc = (s + pad) // c

    def chunks(t):
        t = split_ready(_pad_steps(t, pad), 1, nc)
        return t.view(b, nc, c, h, dd).transpose(2, 3)                      # (b,z,h,c,D)

    r, k, v, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    incl = cumsum(lw, 3)                                   # sum of log w up to t
    excl = torch.cat([torch.zeros_like(incl[:, :, :, :1]), incl[:, :, :, :-1]], dim=3)
    y = torch.sum(r * u[:, None] * k, dim=-1, keepdim=True) * v              # the bonus
    step = max(1, RWKV_PAIR_ELEMS // (b * h * c * c * dd))
    y = y + torch.cat([_ckpt(_wkv_pairs, *(t[:, z:z + step] for t in (r, k, v, excl, incl)))
                       for z in range(0, nc, step)], dim=1)
    to_end = torch.exp(incl[:, :, :, -1:] - incl)                             # (b,z,h,c,D)
    states = torch.matmul((k * to_end).transpose(-1, -2), v)                 # (b,z,h,D,D)
    decay = torch.exp(incl[:, :, :, -1])                                     # (b,z,h,D)
    state, prev = s0, []
    for dz, sz in zip(decay.unbind(1), states.unbind(1)):
        prev.append(state)
        state = dz[..., :, None] * state + sz
    y = y + torch.matmul(r * torch.exp(excl), torch.stack(prev, dim=1))
    y = grad_split_ready(y.transpose(2, 3).reshape(b, nc * c, h, dd), 1, nc)
    return y[:, :s], state


def rwkv6_time_mix(p: dict, x: Tensor, state: Optional[dict],
                   form: Optional[str] = None) -> Tuple[Tensor, dict]:
    """x (B, S, D) -> (y, {"wkv", "shift_t"}); ``state`` (``wkv``,
    ``shift_t``) continues a segment.  ``form`` as in :func:`mamba2_apply`."""
    bsz, s, _ = x.shape
    form = _pick(form, s)
    h = p["wr"].shape[-2]
    xx, new_shift = _token_shift(x, state.get("shift_t") if state else None)
    dx = xx - x
    mr, mk, mv, mw, mg = (p["mu"][i].to(x.dtype) for i in range(5))
    xr, xk, xv, xw, xg = (x + dx * m for m in (mr, mk, mv, mw, mg))

    r, k, v, g = (_proj(xi, p[nm]) for xi, nm in ((xr, "wr"), (xk, "wk"), (xv, "wv"),
                                                   (xg, "wg")))
    # data-dependent decay (the Finch contribution): w_t = exp(-exp(.))
    wlog = p["w0"].float() + torch.matmul(torch.matmul(xw.float(), p["w_lora_a"].float()),
                                          p["w_lora_b"].float())
    u = p["u_bonus"].float()
    s0 = (state["wkv"] if state else
          torch.zeros((bsz, h, RWKV_HEAD, RWKV_HEAD), dtype=torch.float32, device=x.device))
    rf, kf, vf = r.float(), k.float(), v.float()
    if form == "scan":
        w = split_ready(torch.exp(-torch.exp(wlog)), -1, h).reshape(bsz, s, h, RWKV_HEAD)
        y, s_fin = wkv_scan(rf, kf, vf, w, u, s0)
    else:
        logw = split_ready(-torch.exp(wlog), -1, h).reshape(bsz, s, h, RWKV_HEAD)
        y, s_fin = wkv_chunked(rf, kf, vf, logw, u, s0)
    y = rms_norm(y, p["ln_x"]).to(x.dtype) * F.silu(g)
    out = torch.matmul(grad_split_ready(y.flatten(-2), -1, h),
                       grad_split_ready(p["w_o"].to(x.dtype).flatten(0, 1), 0, h))
    return out, {"wkv": s_fin, "shift_t": new_shift}


def rwkv6_channel_mix(p: dict, x: Tensor, state: Optional[dict]) -> Tuple[Tensor, dict]:
    xx, new_shift = _token_shift(x, state.get("shift_c") if state else None)
    dx = xx - x
    mk, mr = p["mu_ff"][0].to(x.dtype), p["mu_ff"][1].to(x.dtype)
    xk, xr = x + dx * mk, x + dx * mr
    k = torch.square(F.relu(torch.matmul(xk, p["wk_ff"].to(x.dtype))))
    kv = torch.matmul(k, p["wv_ff"].to(x.dtype))
    r = torch.sigmoid(torch.matmul(xr, p["wr_ff"].to(x.dtype)))
    return r * kv, {"shift_c": new_shift}
