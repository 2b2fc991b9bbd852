"""Feed-forward blocks: GLU (llama-style), plain MLP, + optional HGQ fake-quant
(port of ``repro.nn.mlp``).

When an architecture enables the paper's technique (``quant="hgq"``), each
projection passes through HGQ fake-quantizers (per-tensor widths on weights
and activations, stacked per layer) and contributes MAC EBOPs to the
β-regularised loss.  Each fake-quant is ``core.quant.fake_quant``, whose
forward on a CUDA tensor is kernel B1.

The reference's ``glu_apply`` also quantizes the GLU input with the ``up``
activation quantizer and discards the result (XLA removes that dead
computation); here it is never computed.  Its EBOPs term, which needs only
the quantizer's bit-width, is kept, so values and gradients are the
reference's, and a GLU forward launches B1 five times: gate weight, gate
input, up weight, down weight, down input.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.quant import QuantConfig, bitwidth, fake_quant
from repro_torch.nn.layers import activation_fn
from repro_torch.nn.params import PDef

QW_LM = QuantConfig(granularity="tensor", signed=True, overflow="SAT",
                    init_f=6.0, init_i=1.0)
QA_LM = QuantConfig(granularity="tensor", signed=True, overflow="SAT",
                    init_f=6.0, init_i=3.0)


def maybe_quant(p: dict, name: str, w: torch.Tensor, x: torch.Tensor, quant: str,
                quantize_x: bool = True):
    """Apply HGQ fake-quant to (w, x) if enabled; returns (wq, xq, ebops).

    With ``quantize_x=False`` the activation is not quantized (``xq`` is
    None) but its quantizer's EBOPs term is computed all the same.
    """
    if quant != "hgq":
        return w, x, torch.zeros((), dtype=torch.float32, device=x.device)
    qw = {"f": p[f"{name}_qwf"], "i": p[f"{name}_qwi"]}
    qa = {"f": p[f"{name}_qaf"], "i": p[f"{name}_qai"]}
    wq = fake_quant(qw, w, QW_LM, train=True)
    xq = fake_quant(qa, x, QA_LM, train=True) if quantize_x else None
    eb = bitwidth(qw, QW_LM) * bitwidth(qa, QA_LM) * float(w.numel())
    return wq.to(x.dtype), xq, torch.sum(eb)


def quant_proj_defs(n_layers: int, names: Tuple[str, ...], quant: str) -> dict:
    if quant != "hgq":
        return {}
    defs = {}
    for nm in names:
        defs[f"{nm}_qwf"] = PDef((n_layers,), ("layers",), init="const", scale=6.0)
        defs[f"{nm}_qwi"] = PDef((n_layers,), ("layers",), init="const", scale=1.0)
        defs[f"{nm}_qaf"] = PDef((n_layers,), ("layers",), init="const", scale=6.0)
        defs[f"{nm}_qai"] = PDef((n_layers,), ("layers",), init="const", scale=3.0)
    return defs


# ---------------------------------------------------------------------- GLU
def glu_defs(n_layers: int, d: int, d_ff: int, quant: str = "none") -> dict:
    defs = {
        "w_gate": PDef((n_layers, d, d_ff), ("layers", "embed", "ffn")),
        "w_up": PDef((n_layers, d, d_ff), ("layers", "embed", "ffn")),
        "w_down": PDef((n_layers, d_ff, d), ("layers", "ffn", "embed")),
    }
    defs.update(quant_proj_defs(n_layers, ("gate", "up", "down"), quant))
    return defs


def glu_apply(p: dict, x: torch.Tensor, act: str,
              quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    f = activation_fn(act)
    wg, xg, e1 = maybe_quant(p, "gate", p["w_gate"].to(x.dtype), x, quant)
    wu, _, e2 = maybe_quant(p, "up", p["w_up"].to(x.dtype), x, quant, quantize_x=False)
    h = f(torch.matmul(xg, wg)) * torch.matmul(xg, wu)
    wd, hq, e3 = maybe_quant(p, "down", p["w_down"].to(x.dtype), h, quant)
    y = torch.matmul(hq, wd)
    return y, e1 + e2 + e3


# ----------------------------------------------------------------- plain MLP
def mlp_defs(n_layers: int, d: int, d_ff: int, quant: str = "none") -> dict:
    defs = {
        "w1": PDef((n_layers, d, d_ff), ("layers", "embed", "ffn")),
        "b1": PDef((n_layers, d_ff), ("layers", "ffn"), init="zeros"),
        "w2": PDef((n_layers, d_ff, d), ("layers", "ffn", "embed")),
        "b2": PDef((n_layers, d), ("layers", None), init="zeros"),
    }
    defs.update(quant_proj_defs(n_layers, ("w1", "w2"), quant))
    return defs


def mlp_apply(p: dict, x: torch.Tensor, act: str,
              quant: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    f = activation_fn(act)
    w1, xq, e1 = maybe_quant(p, "w1", p["w1"].to(x.dtype), x, quant)
    h = f(torch.matmul(xq, w1) + p["b1"].to(x.dtype))
    w2, hq, e2 = maybe_quant(p, "w2", p["w2"].to(x.dtype), h, quant)
    y = torch.matmul(hq, w2) + p["b2"].to(x.dtype)
    return y, e1 + e2
