"""EBOPs resource surrogates and the β trade-off schedule (port of
``repro.core.ebops``, paper §III-B, §IV-A).

* ``ebops_mac``: one MAC between an ``m``-bit and an ``n``-bit operand costs
  ``m*n`` effective bit-operations.
* ``ebops_lut``: Eq. (5), an L-LUT with an ``m``-bit input and ``n``-bit
  output on LUT-X primitives (splittable into ``2**(X-Y)`` LUT-Y's) costs
  ``2**(m-X) * n`` when ``m >= Y`` and ``(m/Y) * 2**(Y-X) * n`` otherwise;
  0-width inputs or outputs cost nothing.  :func:`estimate_luts` applies the
  paper's ``exp(0.985 * log(EBOPs)) ≈ #LUTs`` fit.

The β schedule ramps the accuracy/resource trade-off log-linearly over one
training run (paper §V-A, e.g. 5e-7 → 1e-3 for HLF JSC).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core.quant import clip_tie

# LUT-6 splittable into two LUT-5s (Xilinx 7-series / UltraScale+).
LUT_X = 6
LUT_Y = 5


def ebops_mac(w_bits: torch.Tensor, a_bits: torch.Tensor) -> torch.Tensor:
    """MAC surrogate: ``w_bits`` (..., C_in, C_out), ``a_bits`` (..., C_in)."""
    return torch.sum(w_bits * a_bits[..., :, None])


def ebops_lut(m_bits: torch.Tensor, n_bits: torch.Tensor,
              x: int = LUT_X, y: int = LUT_Y) -> torch.Tensor:
    """Eq. (5) summed over broadcast ``(m, n)`` cell widths; differentiable
    in both, with the reference's gradient at a width of exactly 0."""
    m = clip_tie(m_bits, 0.0, None)
    n = clip_tie(n_bits, 0.0, None)
    wide = torch.exp2(m - x) * n
    narrow = (m / y) * (2.0 ** (y - x)) * n
    cost = torch.where(m >= y, wide, narrow)
    return torch.sum(torch.where((m > 0) & (n > 0), cost, torch.zeros_like(cost)))


def ebops_lut_np(m: np.ndarray, n: np.ndarray, x: int = LUT_X, y: int = LUT_Y) -> float:
    """Host-side (numpy) Eq. (5) for deployment-time reporting."""
    m = np.maximum(np.asarray(m, np.float64), 0.0)
    n = np.maximum(np.asarray(n, np.float64), 0.0)
    cost = np.where(m >= y, np.exp2(m - x) * n, (m / y) * 2.0 ** (y - x) * n)
    return float(np.sum(np.where((m > 0) & (n > 0), cost, 0.0)))


def estimate_luts(ebops: float) -> float:
    """Paper's empirical da4ml calibration: #LUTs ≈ exp(0.985 · log EBOPs)."""
    if ebops <= 0:
        return 0.0
    return float(np.exp(0.985 * np.log(ebops)))


# Smallest β the exponential ramp will start from: a ramp is a line in log
# space, so beta_init <= 0 means log(-inf) and the whole loss goes NaN from
# step 0.  Non-positive starts are floored here (with a warning) instead.
BETA_RAMP_EPS = 1e-12


def beta_ramp_error(beta_init: float, beta_final: float | None) -> str | None:
    """CLI-grade validation of an exponential-ramp request; None when valid."""
    if beta_final is None:
        return None
    if beta_final <= 0.0:
        return (f"beta_final={beta_final} is not a valid ramp endpoint: "
                f"the β ramp is exponential (log-space), so it must be "
                f"> 0.  Omit it for a constant β.")
    if beta_init <= 0.0:
        return (f"beta_init={beta_init} cannot start an exponential ramp "
                f"(log(β₀) diverges); use a small positive value such as "
                f"the paper's 5e-7.")
    return None


@dataclasses.dataclass(frozen=True)
class BetaSchedule:
    """Exponential β ramp over training steps (constant if beta_final is None).

    ``beta_final <= 0`` raises; ``beta_init <= 0`` is floored to
    :data:`BETA_RAMP_EPS` with a warning.  Values are float32, computed like
    the reference's, on the device of the step they are given.
    """

    beta_init: float = 5e-7
    beta_final: float | None = 1e-3
    total_steps: int = 1000

    def __post_init__(self):
        if self.beta_final is None:
            return
        if self.beta_final <= 0.0:
            raise ValueError(
                f"BetaSchedule: beta_final={self.beta_final} — the "
                f"exponential ramp needs a positive endpoint (use "
                f"beta_final=None for a constant β)")
        if self.beta_init <= 0.0:
            warnings.warn(
                f"BetaSchedule: beta_init={self.beta_init} <= 0 would make "
                f"the log-space ramp NaN; flooring to {BETA_RAMP_EPS:g}",
                stacklevel=2)
            object.__setattr__(self, "beta_init", BETA_RAMP_EPS)

    def __call__(self, step) -> torch.Tensor:
        step = torch.as_tensor(step)
        b0 = torch.full((), self.beta_init, dtype=torch.float32, device=step.device)
        if self.beta_final is None:
            return torch.broadcast_to(b0, step.shape)
        b1 = torch.full((), self.beta_final, dtype=torch.float32, device=step.device)
        t = torch.clamp(step.to(torch.float32) / max(self.total_steps - 1, 1), 0.0, 1.0)
        return torch.exp((1.0 - t) * torch.log(b0) + t * torch.log(b1))
