"""Plain PyTorch reference of the CEPC PID hybrid's integer forward.

What the firmware computes for one waveform of ADC codes (the paper's
§V-F hybrid: an HGQ conv front, two LUT-Convs, a LUT head and the window
sum), worked out from the hybrid's weights in plain ``torch`` integer
operations, after the semantics of the JAX package's ``repro.core``
(``lower``, ``tables``, ``dais``) at commit
1e35da467a58367bd43292fb4c37d72db1ec41f5:

* the front quantizes each window's 20 codes onto its activation grid
  (round half to even, saturate), multiplies them by the weights' codes
  (round half to even, saturate), aligns the products on each output's
  grid ``F_c = max_j (f_w + f_a)``, adds the bias rounded onto ``F_c`` and
  applies relu;
* a LUT layer's cell ``(j, i)`` requantizes its input onto the cell's grid,
  takes the low ``m`` bits as the table index (WRAP), reads the cell's
  truth table and aligns it on the layer's common output grid; the layer's
  outputs are the sums over ``j``; a LUT-Conv reads its 3-site patches with
  SAME zero padding, site-major and channel-minor;
* a truth table enumerates the cell's ``2**m`` input codes through its
  one-hidden-layer tanh MLP in float32 (the float function of the trained
  layer) and saturates the result onto the cell's output grid;
* the output is the head's sum over all windows.

It imports nothing of the program and takes only the benchmark's weights
and input codes.  ``dtype`` evaluates the MLPs in another float type (the
control).  The relu's upper clamp is left out: the program sizes that
register to hold every sum it can reach.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

WIDTH_MIN, WIDTH_MAX = -8.0, 12.0


def int_bits(p: Dict[str, torch.Tensor], q: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deployed integer (f, i) of quantizer ``q`` (``lc1/q_in``)."""
    f = torch.round(torch.clamp(p[f"{q}/f"].double(), WIDTH_MIN, WIDTH_MAX)).long()
    i = torch.round(torch.clamp(p[f"{q}/i"].double(), WIDTH_MIN, WIDTH_MAX)).long()
    return f, i


def to_code(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Signed SAT code of float ``x`` on (f, i): round(x 2^f) half to even."""
    width = f + i + 1
    code = torch.round(x.double() * torch.exp2(f.double())).long()
    half = torch.where(width > 0, 1 << torch.clamp(width - 1, min=0), 1)
    code = torch.clamp(code, -half, half - 1)
    return torch.where(width > 0, code, torch.zeros_like(code))


def requant(v: torch.Tensor, src_f, f: torch.Tensor) -> torch.Tensor:
    """Codes ``v`` on grid ``src_f`` moved onto grid ``f``: a left shift, or
    a right shift rounding half to even.  No range handling."""
    s = f - src_f
    up = v << torch.clamp(s, min=0)
    d = torch.clamp(-s, min=0)
    fl = v >> d
    rem = v - (fl << d)
    half = torch.where(d > 0, 1 << torch.clamp(d - 1, min=0), 0)
    down = torch.where(rem > half, fl + 1, torch.where(rem < half, fl, fl + (fl & 1)))
    return torch.where(s >= 0, up, torch.where(d > 0, down, v))


def saturate(v: torch.Tensor, f: torch.Tensor, i: torch.Tensor, signed: bool) -> torch.Tensor:
    width = f + i + (1 if signed else 0)
    n = 1 << torch.clamp(width, min=0)
    lo = -(n >> 1) if signed else torch.zeros_like(n)
    out = torch.minimum(torch.maximum(v, lo), lo + n - 1)
    return torch.where(width > 0, out, torch.zeros_like(out))


# ------------------------------------------------------------------ tables
def tables(p: Dict[str, torch.Tensor], layer: str, dtype=torch.float32) -> Dict:
    """The truth tables of LUT layer ``layer`` on the weights' device."""
    f_in, i_in = int_bits(p, f"{layer}/q_in")
    f_out, i_out = int_bits(p, f"{layer}/q_out")
    m = torch.clamp(f_in + i_in + 1, min=0)
    n = torch.clamp(f_out + i_out + 1, min=0)
    size = torch.where(m > 0, 1 << m, torch.ones_like(m))
    e = torch.arange(int(size.max()), device=m.device)[:, None, None]
    code = torch.remainder(e, size)
    code = torch.where(code >= size // 2, code - size, code)
    x = (code.double() * torch.exp2(-f_in.double())).float().to(dtype)
    w = lambda k: p[f"{layer}/{k}"].to(dtype)
    h = torch.tanh(x[..., None] * w("w0") + w("b0"))
    prod = h * w("w_out")
    y = prod[..., 0]
    for k in range(1, prod.shape[-1]):
        y = y + prod[..., k]
    y = (y + w("b_out")).float()
    out = to_code(y, f_out, i_out)
    live = (m > 0) & (n > 0)
    out = torch.where(live, out, torch.zeros_like(out))
    f_common = int(f_out[live].max()) if bool(live.any()) else 0
    return {"codes": out.permute(1, 2, 0).contiguous(), "size": size, "f_in": f_in,
            "live": live, "align": torch.where(live, f_common - f_out, 0), "f": f_common}


def lut_layer(x: torch.Tensor, src_f: torch.Tensor, t: Dict) -> torch.Tensor:
    """(N, S, C_in) codes on per-channel grids ``src_f`` -> (N, S, C_out)
    codes on the layer's common grid ``t["f"]``."""
    ci, co, n_e = t["codes"].shape
    shifted = requant(x[..., :, None], src_f[:, None], t["f_in"])
    idx = torch.remainder(shifted, t["size"])
    flat = (torch.arange(ci * co, device=x.device).view(ci, co) * n_e) + idx
    vals = t["codes"].view(-1)[flat]
    vals = torch.where(t["live"], vals << t["align"], torch.zeros_like(vals))
    return vals.sum(dim=-2)


def patches_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """(N, S, C) -> (N, S, kernel*C): SAME zero padding (low side first),
    k-major, c-minor."""
    lo = (kernel - 1) // 2
    hi = kernel - 1 - lo
    pad = torch.nn.functional.pad(x, (0, 0, lo, hi))
    idx = torch.arange(x.shape[1], device=x.device)[:, None] + torch.arange(kernel,
                                                                             device=x.device)
    return pad[:, idx].reshape(x.shape[0], x.shape[1], kernel * x.shape[2])


# ------------------------------------------------------------------ front
def front_spec(p: Dict[str, torch.Tensor]) -> Dict:
    fa, ia = int_bits(p, "front/q_a")
    fw, iw = int_bits(p, "front/q_w")
    w_codes = to_code(p["front/w"], fw, iw)
    grid = (fw + fa[:, None]).max(dim=0).values
    b_codes = torch.round(p["front/b"].double() * torch.exp2(grid.double())).long()
    return {"fa": fa, "ia": ia, "w": w_codes << (grid - fw - fa[:, None]),
            "b": b_codes, "f": grid}


def front(codes: torch.Tensor, spec: Dict, in_f: int, window: int) -> torch.Tensor:
    """(N, T) input codes -> (N, T // window, C) relu codes on grids ``f``."""
    x = codes.long().view(codes.shape[0], -1, window)
    act = saturate(requant(x, in_f, spec["fa"]), spec["fa"], spec["ia"], True)
    acc = (act[..., :, None] * spec["w"]).sum(dim=-2) + spec["b"]
    return torch.clamp(acc, min=0)


# ------------------------------------------------------------------ chain
def prepare(p: Dict[str, torch.Tensor], cfg: Dict, dtype=torch.float32) -> Dict:
    """Everything the forward derives from the weights: the front's codes
    and each LUT layer's tables."""
    return {"front": front_spec(p),
            "luts": [tables(p, name, dtype) for name in cfg["lut_layers"]]}


def forward(codes: torch.Tensor, prep: Dict, cfg: Dict, block: int = 256) -> torch.Tensor:
    """(N, T) ADC codes -> (N,) output codes, ``block`` rows at a time."""
    outs: List[torch.Tensor] = []
    kernels = cfg["lut_kernels"]
    for lo in range(0, codes.shape[0], block):
        h = front(codes[lo:lo + block], prep["front"], cfg["input_grid"]["f"], cfg["window"])
        f = prep["front"]["f"]
        for t, k in zip(prep["luts"], kernels):
            x = patches_same(h, k) if k > 1 else h
            src = f.repeat(k) if k > 1 else f
            h = lut_layer(x, src, t)
            f = torch.full((h.shape[-1],), t["f"], device=h.device, dtype=torch.long)
        outs.append(h.sum(dim=1)[:, 0])
    return torch.cat(outs)


def chain_stages(prep: Dict, cfg: Dict, ctx: int) -> List[Dict]:
    """The chain's stages as ``bench.counts.roofline.pid_chain_ops`` counts
    them: how many cells of each LUT layer requantize their input."""
    sites = ctx // cfg["window"]
    fr = prep["front"]
    out = [{"kind": "mac", "sites": sites, "c_in": int(fr["w"].shape[0]),
            "c_out": int(fr["w"].shape[1]), "relu": True}]
    f = fr["f"]
    for t, k in zip(prep["luts"], cfg["lut_kernels"]):
        src = f.repeat(k) if k > 1 else f
        shift = int(((t["f_in"] != src[:, None]) & t["live"]).sum())
        ci, co, _ = t["codes"].shape
        out.append({"kind": "lut", "sites": sites, "c_in": ci, "c_out": co, "shift": shift})
        f = torch.full((co,), t["f"], device=f.device, dtype=torch.long)
    out.append({"kind": "sum", "sites": sites, "c": int(out[-1]["c_out"])})
    return out


def table_bytes(prep: Dict, p: Dict[str, torch.Tensor], cfg: Dict) -> int:
    """Bytes of every live table entry, each in the narrowest of 1, 2, 4
    or 8 bytes that holds its output width."""
    total = 0
    for t, name in zip(prep["luts"], cfg["lut_layers"]):
        f_out, i_out = int_bits(p, f"{name}/q_out")
        n = torch.clamp(f_out + i_out + 1, min=0)
        nbytes = torch.where(n <= 8, 1, torch.where(n <= 16, 2, torch.where(n <= 32, 4, 8)))
        total += int((torch.where(t["live"], t["size"] * nbytes, 0)).sum())
    return total
