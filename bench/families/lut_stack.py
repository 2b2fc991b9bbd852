"""The LUT-Dense stack (JSC-HLF) as the train kind drives it.

The benchmark makes the inputs: the training set from the frozen
``jsc_hlf`` generator on the configuration's input grid, each step's rows
from the seed, and the initial parameters, drawn on the card from the seed
with the program builder's distributions (``launch/serve.py::
build_lut_stack``, ``core/lut_layers.LUTDense``).  The program gets them
through its own builder, whose draws are then overwritten, and trains them
with its own step (``train/steps.py::make_lut_train_step``, fused path)
and loop (``train/loop.py::chunked_train``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bench.data.synthetic import int_to_float, jsc_hlf, quantize_to_int

KERNELS = ("fake_quant", "lut_dense", "lut_dense_bwd")


def _layer_shapes(cfg: Dict):
    return list(enumerate(zip(cfg["dims"][:-1], cfg["dims"][1:])))


def init_params(cfg: Dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                       Dict[str, torch.Tensor]]:
    """``(params, state)`` keyed by the program's paths (``l0/w0``,
    ``l0/q_in/f``; ``l0/bn_mean``): the normal draws in one call on the
    card from ``seed``, scaled as ``LUTDense`` scales them (w0 by 1, b0 by
    1/2, w_out by (H·C_in)^-1/2), b_out 0, the widths at the configured
    initial values, batch-norm at identity."""
    h = cfg["hidden"]
    shapes = _layer_shapes(cfg)
    n = sum(3 * ci * co * h for _, (ci, co) in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    params, state, off = {}, {}, 0
    for k, (ci, co) in shapes:
        for name, scale in (("w0", 1.0), ("b0", 0.5), ("w_out", (h * ci) ** -0.5)):
            params[f"l{k}/{name}"] = draws[off:off + ci * co * h].view(ci, co, h) * scale
            off += ci * co * h
        params[f"l{k}/b_out"] = torch.zeros(ci, co, device=device)
        for q in ("q_in", "q_out"):
            for w in ("f", "i"):
                params[f"l{k}/{q}/{w}"] = torch.full(
                    (ci, co), float(cfg[q][f"init_{w}"]), device=device)
        if k in cfg["batchnorm_layers"]:
            params[f"l{k}/bn_scale"] = torch.ones(ci, co, device=device)
            params[f"l{k}/bn_bias"] = torch.zeros(ci, co, device=device)
            state[f"l{k}/bn_mean"] = torch.zeros(ci, co, device=device)
            state[f"l{k}/bn_var"] = torch.ones(ci, co, device=device)
    return params, state


class Data:
    """The host training set and each step's rows.  A permutation of the
    set is drawn from the seed once; epoch ``e`` reads it from an offset
    drawn from ``(seed, e)``, wrapping round, so the rows of a step all
    differ, every epoch's batches differ, a step's batch is a pure function
    of the seed and the step, and no step costs more host time than
    another."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int):
        g = cfg["input_grid"]
        x, y = jsc_hlf(seed, traffic["n_train"], "train")
        codes = quantize_to_int(x, g["f"], g["i"], g["signed"], g["overflow"])
        self.x = int_to_float(codes, g["f"]).astype(np.float32)
        self.y = y
        self.seed, self.batch = seed, traffic["batch"]
        self.per_epoch = len(self.x) // self.batch
        self.perm = np.random.default_rng(np.random.SeedSequence([seed, 1000])).permutation(
            len(self.x))
        self._span = np.arange(self.batch)

    def rows(self, step: int) -> np.ndarray:
        epoch, k = divmod(step, self.per_epoch)
        off = np.random.SeedSequence([self.seed, 1001, epoch]).generate_state(1)[0]
        start = (int(off) + k * self.batch) % len(self.perm)
        return self.perm[(start + self._span) % len(self.perm)]

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        idx = self.rows(step)
        return {"x": self.x[idx], "y": self.y[idx]}


def build(cfg: Dict, params: Dict[str, torch.Tensor], state: Dict[str, torch.Tensor],
          device):
    """The program's stack, step and Adam state, holding ``params`` and
    ``state``: ``(layers, step_fn, trained, opt_state, beta1)`` where
    ``trained`` is the dict of tensors the step trains in place."""
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.launch import serve as launch_serve
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.train import steps

    hp = cfg["train"]
    layers = launch_serve.build_lut_stack(list(cfg["dims"]), cfg["hidden"], device=device,
                                          generator=torch.Generator().manual_seed(0))
    trained = steps.named_params(layers)
    if set(trained) != set(params):
        raise KeyError(f"the program's parameters {sorted(trained)} are not the "
                       f"benchmark's {sorted(params)}")
    with torch.no_grad():
        for k, p in trained.items():
            p.copy_(params[k])
        for k, v in state.items():
            layer, name = k.split("/", 1)
            getattr(layers[int(layer[1:])], name).copy_(v)
    for layer in layers:
        layer.bn_momentum = cfg["bn_momentum"]
    thp = steps.TrainHParams(
        adam=AdamConfig(lr=hp["lr"], b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                        clip_norm=hp["clip_norm"]),
        beta=BetaSchedule(hp["beta_init"], hp["beta_final"], hp["nominal_steps"]),
        lr_schedule=cosine_restarts(hp["lr"], first_period=hp["lr_first_period"],
                                    t_mult=hp["lr_t_mult"], min_frac=hp["lr_min_frac"],
                                    warmup=hp["lr_warmup"]),
        lut_use_fused=True)
    step_fn, init_fn = steps.make_lut_train_step(layers, thp)
    return layers, step_fn, trained, init_fn(), hp["b1"]


def state_of(layers, trained: Dict[str, torch.Tensor], state_keys) -> Dict[str, torch.Tensor]:
    """The program's parameters and batch-norm stats, copied to the host."""
    out = {k: p.detach().float().cpu().clone() for k, p in trained.items()}
    for k in state_keys:
        layer, name = k.split("/", 1)
        out[k] = getattr(layers[int(layer[1:])], name).detach().float().cpu().clone()
    return out


def train_ops_per_sample(cfg: Dict) -> int:
    from bench.counts.roofline import lut_stack_train_ops

    return lut_stack_train_ops(cfg["dims"], cfg["hidden"])


def kernel_bounds(cfg: Dict, batch: int) -> Dict[str, float]:
    """The bound of one launch, in seconds, of each kernel the step runs:
    B1 twice on layer 0's einsum path (its input expanded, its output
    contiguous; the mean of the two), B2 and B3 once each on the fused
    layers (the mean over them)."""
    from bench.counts import roofline as rl

    h = cfg["hidden"]
    b1, fused = [], []
    for k, (ci, co) in _layer_shapes(cfg):
        if k in cfg["batchnorm_layers"]:
            b1 += [rl.b1_expand(batch, ci, co)[0], rl.b1_contiguous(batch, ci, co)[0]]
        else:
            fused.append((ci, co))
    out = {}
    if b1:
        out["fake_quant"] = sum(b1) / len(b1)
    if fused:
        out["lut_dense"] = sum(rl.b2(batch, ci, co, h)[0] for ci, co in fused) / len(fused)
        out["lut_dense_bwd"] = sum(rl.b3(batch, ci, co, h)[0] for ci, co in fused) / len(fused)
    return out
