"""The LUT-Dense layer (paper §III-A, Algorithm 1), port of
``repro.core.lut_layers.LUTDense``.

Each output of a LUT-Dense layer is a *sum of 1-input logical LUTs*::

    a_i = Σ_j  L-LUT_{i,j}( x_j )                                   (Eq. 1)

Every L-LUT_{i,j} is a tiny MLP (one hidden layer of width ``hidden`` with
tanh by default) evaluated element-wise over the (C_in × C_out) grid.  Inputs
go through a WRAP quantizer and outputs through a SAT quantizer, each with one
(f, i) pair per cell.

The module keeps the reference's parameter keys and layouts: ``w0``/``b0``/
``w_out`` are ``(C_in, C_out, H)``, ``b_out`` and the quantizer widths
``(C_in, C_out)``, BN stats ``(C_in, C_out)``; the transpose to the kernel's
``(C_in, H, C_out)`` happens at the kernel call.

``forward`` follows ``module.training``.  With ``use_fused`` it goes through
the fused pair (kernel B2 forward, kernel B3 backward, ``kernels/ops.py``).
In train mode with batch-norm the batch statistics of the pre-quantization
cell outputs come first, from their own kernel pair (``ops.lut_bn_stats``),
and are folded into B2's output projection as the eval path folds the
moving stats; a batch-norm layer the fused pair does not cover (more
hidden layers, relu, other quantizers) takes the einsum path in train
mode, as in the reference.

``LUTConv1D`` / ``LUTConv2D`` are im2col followed by LUT-Dense (paper
§IV-A): each holds a ``dense`` LUT-Dense over the ``(kernel·C_in, C_out)``
cell grid, whose parameters carry the reference's keys, and runs it on the
patches of :func:`im2col_1d` / :func:`im2col_2d` (k-major, c-minor, as the
lowering's patch grids assume).  Patches are taken with ``F.pad`` and
``Tensor.unfold``: their backward sums each input's windows in a fixed
order, with no atomics, so a step repeats bit for bit on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.ebops import ebops_lut
from repro_torch.core.quant import (QuantConfig, bitwidth, fake_quant,
                                    init_quantizer, ste_bits)
from repro_torch.nn.base import Aux

# paper defaults: inputs wrap, outputs saturate (see repro.core.lut_layers)
Q_IN_DEFAULT = QuantConfig(granularity="element", signed=True, overflow="WRAP",
                           init_f=4.0, init_i=4.0)
Q_OUT_DEFAULT = QuantConfig(granularity="element", signed=True, overflow="SAT",
                            init_f=4.0, init_i=3.0)


def _quantizer(cfg: QuantConfig, shape, device) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in
                             init_quantizer(cfg, shape, device=device).items()})


class LUTDense(nn.Module):
    """LUT-Dense layer; ``forward(x) -> (y, Aux)`` in the module's train or
    eval mode (eval after construction).

    Weights are drawn from ``generator`` (no global RNG) on the generator's
    device and then moved to ``device``, so one seed gives one set of weights
    on every device.
    """

    def __init__(self, c_in: int, c_out: int, hidden: int = 8,
                 n_hidden_layers: int = 1, activation: str = "tanh",
                 use_batchnorm: bool = False,
                 q_in: QuantConfig = Q_IN_DEFAULT,
                 q_out: QuantConfig = Q_OUT_DEFAULT,
                 use_fused: bool = False, bn_momentum: float = 0.99, *,
                 device="cuda", generator: torch.Generator):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"unknown activation {activation!r}")
        self.c_in, self.c_out, self.hidden = c_in, c_out, hidden
        self.n_hidden_layers = n_hidden_layers
        self.activation = activation
        self.use_batchnorm = use_batchnorm
        self.cfg_in, self.cfg_out = q_in, q_out
        self.use_fused = use_fused
        self.bn_momentum = bn_momentum
        ci, co, h = c_in, c_out, hidden

        def normal(*shape):
            t = torch.randn(shape, generator=generator, device=generator.device)
            return t.to(device)

        self.w0 = nn.Parameter(normal(ci, co, h) * 1.0)
        self.b0 = nn.Parameter(normal(ci, co, h) * 0.5)
        for l in range(1, n_hidden_layers):
            self.register_parameter(
                f"w{l}", nn.Parameter(normal(ci, co, h, h) * (h ** -0.5)))
            self.register_parameter(
                f"b{l}", nn.Parameter(torch.zeros(ci, co, h, device=device)))
        # last level: h -> 1, scaled so per-cell outputs start O(1/sqrt(C_in))
        self.w_out = nn.Parameter(normal(ci, co, h) * (h * ci) ** -0.5)
        self.b_out = nn.Parameter(torch.zeros(ci, co, device=device))
        self.q_in = _quantizer(q_in, (ci, co), device)
        self.q_out = _quantizer(q_out, (ci, co), device)
        if use_batchnorm:
            self.bn_scale = nn.Parameter(torch.ones(ci, co, device=device))
            self.bn_bias = nn.Parameter(torch.zeros(ci, co, device=device))
            self.register_buffer("bn_mean", torch.zeros(ci, co, device=device))
            self.register_buffer("bn_var", torch.ones(ci, co, device=device))
        self.train(False)

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x) if self.activation == "tanh" else torch.relu(x)

    # ----------------------------------------------------------- cell eval
    def cell_mlp(self, xq: torch.Tensor) -> torch.Tensor:
        """All (C_in, C_out) L-LUT MLPs on quantized input ``xq``.

        ``xq``: (..., C_in, C_out).  Returns the pre-output-quantization
        values, shape (..., C_in, C_out) — the exact function truth-table
        extraction enumerates.  Every step is element-wise and the sum over
        the hidden axis runs in index order, so a value depends only on its
        own cell and input, whatever the batch shape or device kernel.
        """
        h = self._act(xq[..., None] * self.w0 + self.b0)
        for l in range(1, self.n_hidden_layers):
            w, b = getattr(self, f"w{l}"), getattr(self, f"b{l}")
            h = self._act(torch.einsum("...ioh,iohg->...iog", h, w) + b)
        p = h * self.w_out
        y = p[..., 0]
        for k in range(1, p.shape[-1]):
            y = y + p[..., k]
        return y + self.b_out

    def bn_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Deployment-time fused BN: y <- y*scale' + bias' from moving stats."""
        inv = self.bn_scale * torch.rsqrt(self.bn_var + 1e-5)
        return inv, self.bn_bias - self.bn_mean * inv

    def _ebops(self) -> torch.Tensor:
        return ebops_lut(bitwidth(self.q_in, self.cfg_in),
                         bitwidth(self.q_out, self.cfg_out))

    # ------------------------------------------------- fused kernels B2/B3
    def fused_covers(self) -> bool:
        """Whether the fused kernels cover this layer's cells: the paper
        default, one hidden tanh layer between a signed WRAP input and a
        signed SAT output quantizer."""
        return (self.n_hidden_layers == 1 and self.activation == "tanh"
                and self.cfg_in.overflow == "WRAP" and self.cfg_out.overflow == "SAT"
                and self.cfg_in.signed and self.cfg_out.signed)

    def _cell_args(self, train: bool) -> Tuple[torch.Tensor, ...]:
        """:meth:`kernel_args` before the batch-norm fold, attached."""
        if self.n_hidden_layers != 1 or self.activation != "tanh":
            raise NotImplementedError("fused kernel covers the paper default "
                                      "(1 hidden tanh layer)")
        if not self.fused_covers():
            raise NotImplementedError("fused kernel covers the paper default "
                                      "quantizers (signed WRAP in, signed "
                                      "SAT out)")
        w0 = self.w0.permute(0, 2, 1)                       # (Ci, H, Co)
        b0 = self.b0.permute(0, 2, 1)
        wo = self.w_out.permute(0, 2, 1)
        grid = (self.c_in, self.c_out)
        fi, ii = ste_bits(self.q_in, self.cfg_in, train=train)
        fo, io = ste_bits(self.q_out, self.cfg_out, train=train)
        fi, ii, fo, io = (torch.broadcast_to(a, grid) for a in (fi, ii, fo, io))
        return tuple(a.float().contiguous()
                     for a in (w0, b0, wo, self.b_out, fi, ii, fo, io))

    def kernel_args(self, train: bool = False) -> Tuple[torch.Tensor, ...]:
        """``(w0, b0, w_out, b_out, f_in, i_in, f_out, i_out)`` as kernels
        B2/B3 take them: weights transposed to (C_in, H, C_out), BN folded
        into the output projection from its moving stats, STE-rounded widths
        broadcast to (C_in, C_out), all contiguous float32.  With ``train``
        they stay attached to the parameters, so gradients reach ``w0`` /
        ``b0`` / ``w_out`` through the transpose and the bit-width
        parameters through the clip and ``round_ste``; else detached."""
        w0, b0, wo, bo, fi, ii, fo, io = self._cell_args(train)
        if self.use_batchnorm:
            scale, bias = self.bn_affine()
            wo = wo * scale[:, None, :]
            bo = bo * scale + bias
        args = (w0, b0, wo, bo, fi, ii, fo, io)
        return args if train else tuple(a.detach() for a in args)

    def _fused_bn_train(self, x: torch.Tensor):
        """Train-mode batch-norm on the fused pair: each cell's batch mean
        and population variance from ``ops.lut_bn_stats``, folded into the
        output projection (``w_out * inv``, ``(b_out - mean) * inv +
        bn_bias`` with ``inv = bn_scale * rsqrt(var + 1e-5)``), then B2/B3.
        Gradients reach the statistics through the fold.  Returns the
        output and the moving-stat updates."""
        from repro_torch.kernels import ops

        lead = x.shape[:-1]
        xf = x.reshape(-1, self.c_in).float().contiguous()
        w0, b0, wo, bo, fi, ii, fo, io = self._cell_args(True)
        mean, var = ops.lut_bn_stats(xf, w0, b0, wo, bo, fi, ii)
        inv = self.bn_scale * torch.rsqrt(var + 1e-5)
        wo = wo * inv[:, None, :]
        bo = (bo - mean) * inv + self.bn_bias
        y = ops.lut_dense(xf, w0, b0, wo, bo, fi, ii, fo, io)
        m = self.bn_momentum
        updates = {"bn_mean": m * self.bn_mean + (1 - m) * mean.detach(),
                   "bn_var": m * self.bn_var + (1 - m) * var.detach()}
        return y.reshape(*lead, self.c_out), updates

    def _fused_forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        from repro_torch.kernels import ops

        lead = x.shape[:-1]
        xf = x.reshape(-1, self.c_in).float().contiguous()
        y = ops.lut_dense(xf, *self.kernel_args(train=train))
        return y.reshape(*lead, self.c_out)

    def apply_fused(self, x: torch.Tensor) -> torch.Tensor:
        """Eval forward through kernel B2 (``kernels/ops.lut_dense``)."""
        return self._fused_forward(x, train=False)

    # ---------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, *, fused: Optional[bool] = None
                ) -> Tuple[torch.Tensor, Aux]:
        """``fused`` overrides ``use_fused`` for this call (the train step's
        ``lut_use_fused`` routes a stack without changing its layers)."""
        if x.shape[-1] != self.c_in:
            raise ValueError(f"expected (..., {self.c_in}), got {tuple(x.shape)}")
        train = self.training
        fused = self.use_fused if fused is None else fused
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if fused and not (self.use_batchnorm and train):
            return (self._fused_forward(x, train=train),
                    Aux(ebops=self._ebops(), aux_loss=zero))
        if fused and self.fused_covers():       # BN + train: the statistics' pair first
            y, updates = self._fused_bn_train(x)
            return y, Aux(ebops=self._ebops(), aux_loss=zero, updates=updates)
        cells, updates = self._cells(x, train)
        out = torch.sum(cells, dim=-2)                 # Σ over C_in — Eq. (1)
        return out, Aux(ebops=self._ebops(), aux_loss=zero, updates=updates)

    def cell_outputs(self, x: torch.Tensor) -> torch.Tensor:
        """Per-cell SAT-quantized L-LUT outputs (..., C_in, C_out) of the eval
        (einsum-path) forward, before the Σ over C_in."""
        return self._cells(x, False)[0]

    def _cells(self, x: torch.Tensor, train: bool):
        """Einsum-path cell outputs and the BN moving-stat updates (train)."""
        # Alg. 1 lines 1-2: broadcast to (..., C_in, C_out), input-quantize
        xb = x[..., :, None].expand(*x.shape, self.c_out)
        xq = fake_quant(self.q_in, xb, self.cfg_in, train=train)
        y = self.cell_mlp(xq)
        updates = {}
        if self.use_batchnorm:
            if train:
                axes = tuple(range(y.dim() - 2))
                mean = torch.mean(y, dim=axes)
                var = torch.var(y, dim=axes, correction=0)   # population, as jnp.var
                m = self.bn_momentum
                updates["bn_mean"] = m * self.bn_mean + (1 - m) * mean.detach()
                updates["bn_var"] = m * self.bn_var + (1 - m) * var.detach()
            else:
                mean, var = self.bn_mean, self.bn_var
            y = (y - mean) * torch.rsqrt(var + 1e-5) * self.bn_scale + self.bn_bias
        return fake_quant(self.q_out, y, self.cfg_out, train=train), updates


# --------------------------------------------------------------------------- #
# im2col helpers + LUT-Conv
# --------------------------------------------------------------------------- #
def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """SAME padding as ``jax.lax.conv`` / TF: ceil(size/stride) output
    positions, total pad ``(out-1)*stride + kernel - size`` clamped at 0,
    split low side first."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + kernel - size, 0)
    return pad // 2, pad - pad // 2


def _windows(x: torch.Tensor, dim: int, kernel: int, stride: int) -> torch.Tensor:
    """``x.unfold(dim, kernel, stride)``, empty where ``x`` is shorter than
    one window (the reference's index grid then has no rows)."""
    if x.shape[dim] < kernel:
        shape = list(x.shape)
        shape[dim] = 0
        return x.new_zeros(shape + [kernel])
    return x.unfold(dim, kernel, stride)


def im2col_1d(x: torch.Tensor, kernel: int, stride: int = 1,
              padding: str = "VALID") -> torch.Tensor:
    """(..., T, C) -> (..., T', kernel*C) patch extraction, k-major and
    c-minor (``repro.core.lut_layers.im2col_1d``)."""
    if padding == "SAME":
        lo, hi = _same_pads(x.shape[-2], kernel, stride)
        x = F.pad(x, (0, 0, lo, hi))
    p = _windows(x, -2, kernel, stride)                 # (..., T', C, K)
    p = p.transpose(-1, -2)                             # (..., T', K, C)
    return p.reshape(*p.shape[:-2], kernel * x.shape[-1])


def im2col_2d(x: torch.Tensor, kernel: Tuple[int, int],
              stride: Tuple[int, int] = (1, 1),
              padding: str = "VALID") -> torch.Tensor:
    """(..., H, W, C) -> (..., H', W', kh*kw*C), (kh, kw)-major, c-minor."""
    kh, kw = kernel
    sh, sw = stride
    if padding == "SAME":
        hlo, hhi = _same_pads(x.shape[-3], kh, sh)
        wlo, whi = _same_pads(x.shape[-2], kw, sw)
        x = F.pad(x, (0, 0, wlo, whi, hlo, hhi))
    c = x.shape[-1]
    p = _windows(x, -3, kh, sh)                         # (..., H', W, C, kh)
    p = _windows(p, -3, kw, sw)                         # (..., H', W', C, kh, kw)
    n = p.dim()
    p = p.permute(*range(n - 3), n - 2, n - 1, n - 3)  # (..., H', W', kh, kw, C)
    return p.reshape(*p.shape[:-3], kh * kw * c)


class _LUTConv(nn.Module):
    """im2col + a ``dense`` LUT-Dense; ``forward(x) -> (y, Aux)``."""

    def _patches(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor, *, fused: Optional[bool] = None):
        return self.dense(self._patches(x), fused=fused)


class LUTConv1D(_LUTConv):
    """1-D LUT-Conv over (..., T, C_in); the cells are ``dense``'s
    ``(kernel*C_in, C_out)`` grid, shared by every output position."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: str = "VALID", hidden: int = 8,
                 n_hidden_layers: int = 1, activation: str = "tanh",
                 use_batchnorm: bool = False,
                 q_in: QuantConfig = Q_IN_DEFAULT,
                 q_out: QuantConfig = Q_OUT_DEFAULT,
                 use_fused: bool = False, *, device="cuda",
                 generator: torch.Generator):
        super().__init__()
        self.c_in, self.c_out, self.kernel = c_in, c_out, kernel
        self.stride, self.padding = stride, padding
        self.hidden, self.activation = hidden, activation
        self.dense = LUTDense(c_in * kernel, c_out, hidden, n_hidden_layers,
                              activation, use_batchnorm, q_in, q_out,
                              use_fused, device=device, generator=generator)
        self.train(False)

    def _patches(self, x):
        return im2col_1d(x, self.kernel, self.stride, self.padding)


class LUTConv2D(_LUTConv):
    """2-D LUT-Conv over (..., H, W, C_in); cells ``(kh*kw*C_in, C_out)``."""

    def __init__(self, c_in: int, c_out: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: str = "VALID",
                 hidden: int = 8, n_hidden_layers: int = 1,
                 activation: str = "tanh", use_batchnorm: bool = False,
                 q_in: QuantConfig = Q_IN_DEFAULT,
                 q_out: QuantConfig = Q_OUT_DEFAULT,
                 use_fused: bool = False, *, device="cuda",
                 generator: torch.Generator):
        super().__init__()
        self.c_in, self.c_out = c_in, c_out
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.padding = padding
        self.hidden, self.activation = hidden, activation
        kh, kw = self.kernel
        self.dense = LUTDense(c_in * kh * kw, c_out, hidden, n_hidden_layers,
                              activation, use_batchnorm, q_in, q_out,
                              use_fused, device=device, generator=generator)
        self.train(False)

    def _patches(self, x):
        return im2col_2d(x, self.kernel, self.stride, self.padding)
