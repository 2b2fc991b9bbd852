"""Basic NN building blocks: norms, embeddings, positional encodings (port of
``repro.nn.layers``).

All functions are pure; parameter shapes come from PDef builders
(``nn/params.py``).  Norms and rotary embeddings compute in float32 and cast
back, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.params import PDef


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: Optional[torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.float())
    return y.to(dt)


def layer_norm(x: torch.Tensor, scale, bias: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; with scale=bias=None this is OLMo's non-parametric LN.
    The variance is the population variance, as ``jnp.var``'s."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def norm_defs(n_layers: int, d: int, norm_type: str, nonparam: bool,
              n_norms: int = 2) -> dict:
    """Per-block norm params, stacked over layers. Empty dict if non-parametric."""
    if nonparam:
        return {}
    out = {}
    for k in range(n_norms):
        out[f"norm{k}"] = PDef((n_layers, d), ("layers", None), init="zeros")
        if norm_type == "layernorm":
            out[f"norm{k}_bias"] = PDef((n_layers, d), ("layers", None), init="zeros")
    return out


def apply_norm(p_block: dict, idx: int, x: torch.Tensor, norm_type: str,
               nonparam: bool) -> torch.Tensor:
    if norm_type == "rmsnorm":
        return rms_norm(x, None if nonparam else p_block[f"norm{idx}"])
    scale = None if nonparam else 1.0 + p_block[f"norm{idx}"]
    bias = None if nonparam else p_block[f"norm{idx}_bias"]
    return layer_norm(x, scale, bias)


# --------------------------------------------------------------- embeddings
def embed_lookup(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table[ids.long()].to(compute_dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    f32 = torch.float32
    pos = torch.arange(n, device=device)[:, None].to(f32)
    dim = torch.arange(d // 2, device=device)[None, :].to(f32)
    inv = torch.exp(-torch.log(torch.full((), 10000.0, dtype=f32, device=device))
                    * dim / (d // 2))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, N, hd); positions: (..., S).  Float32
    inside, cast back to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = torch.float32
    log_theta = torch.log(torch.full((), theta, dtype=f32, device=x.device))
    freq = torch.exp(-log_theta * torch.arange(half, dtype=f32, device=x.device) / half)
    ang = positions[..., None].to(f32) * freq                     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                            # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
               "tanh": torch.tanh, "relu2": _relu2}


def activation_fn(name: str):
    return ACTIVATIONS[name]
