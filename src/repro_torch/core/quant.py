"""HGQ fixed-point quantizers, eval subset (port of ``repro.core.quant``).

A quantized value with sign bit ``k`` (0/1), integer bits ``i`` and
fractional bits ``f`` lives on the grid ``2**-f * Z`` restricted to
``[-k * 2**i, 2**i - 2**-f]``; total physical width ``b = k + i + f``.
WRAP wraps out-of-range values modulo the grid span (dropping carry bits in
hardware), SAT clamps them, and an element whose width is ``<= 0`` is pruned
to exactly 0.

Only the eval forward lives here: bit-widths are clipped and rounded with
gradients stopped.  The trainable surrogate gradients wait for the training
slice.  :func:`quantize_to_int` / :func:`int_to_float` are the bit-exact
numpy path shared by truth-table extraction and the DAIS interpreter.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


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


def _fq_eval(x: torch.Tensor, f: torch.Tensor, i: torch.Tensor,
             signed: bool, overflow: str) -> torch.Tensor:
    scale = torch.exp2(-f)
    hi = torch.exp2(i) - scale
    lo = -torch.exp2(i) if signed else torch.zeros_like(hi)
    q = torch.round(x / scale) * scale            # round half to even
    if overflow == "SAT":
        q = torch.minimum(torch.maximum(q, lo), hi)
    else:  # WRAP: a floor-mod like jnp.mod, hence remainder and not fmod
        span = hi - lo + scale
        q = lo + torch.remainder(q - lo, span)
    width = i + f + (1.0 if signed else 0.0)
    return torch.where(width > 0.0, q, torch.zeros_like(q))


def ste_bits(qp: dict, cfg: QuantConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped and rounded ``(f, i)`` with gradients stopped (eval widths)."""
    f = torch.round(torch.clamp(qp["f"].detach(), cfg.min_f, cfg.max_f))
    i = torch.round(torch.clamp(qp["i"].detach(), cfg.min_i, cfg.max_i))
    return f, i


def fake_quant(qp: dict, x: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Eval-mode projection of ``x`` onto the grid described by ``qp``."""
    f, i = ste_bits(qp, cfg)
    return _fq_eval(x.float(), f, i, cfg.signed, cfg.overflow).to(x.dtype)


def bitwidth(qp: dict, cfg: QuantConfig) -> torch.Tensor:
    """Effective physical bit-width per parameter element (>= 0)."""
    f, i = ste_bits(qp, cfg)
    k = 1.0 if cfg.signed else 0.0
    return torch.clamp(f + i + k, min=0.0)


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
