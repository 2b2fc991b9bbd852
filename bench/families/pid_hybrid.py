"""The CEPC PID hybrid as the score kind drives it.

The benchmark makes the inputs: the weights, drawn on the card from the
seed with the program builder's distributions (``models/pid.py::
build_pid_layers``: the front's ``w`` by C_in^-1/2, each LUT layer's w0 by
1, b0 by 1/2, w_out by (H·C_in)^-1/2, biases 0, widths at their initial
values), and a pool of waveforms from the frozen ``cepc_waveform``
generator as 12-bit ADC codes.  The program gets the weights through its
own builder, whose draws are then overwritten, lowers the hybrid over the
cell's context (``core/lower.py``) and builds its engine behind the gate
(``serve/api.py::build``, kernel B4 required).
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch

from bench.data.synthetic import cepc_waveform, quantize_to_int

KERNELS = ("lut_serve",)


def _lut_shapes(cfg: Dict):
    """(name, c_in cells, c_out) of each LUT layer's cell grid."""
    out, c = [], cfg["features"]
    for name, k, co in zip(cfg["lut_layers"], cfg["lut_kernels"], cfg["lut_out"]):
        out.append((name, k * c, co))
        c = co
    return out


def init_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The hybrid's parameters keyed by the program's paths (``front/w``,
    ``lc1/q_in/f``), every normal draw in one call on the card."""
    h, win, feat = cfg["hidden"], cfg["window"], cfg["features"]
    luts = _lut_shapes(cfg)
    n = win * feat + sum(3 * ci * co * h for _, ci, co in luts)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    fq = cfg["front"]
    p = {"front/w": draws[:win * feat].view(win, feat) * win ** -0.5,
         "front/b": torch.zeros(feat, device=device)}
    for q, shape in (("q_w", (win, feat)), ("q_a", (win,))):
        for w in ("f", "i"):
            p[f"front/{q}/{w}"] = torch.full(shape, float(fq[q][f"init_{w}"]), device=device)
    off = win * feat
    for name, ci, co in luts:
        for key, scale in (("w0", 1.0), ("b0", 0.5), ("w_out", (h * ci) ** -0.5)):
            p[f"{name}/{key}"] = draws[off:off + ci * co * h].view(ci, co, h) * scale
            off += ci * co * h
        p[f"{name}/b_out"] = torch.zeros(ci, co, device=device)
        for q in ("q_in", "q_out"):
            for w in ("f", "i"):
                p[f"{name}/{q}/{w}"] = torch.full((ci, co), float(cfg[q][f"init_{w}"]),
                                                  device=device)
    return p


def pool(cfg: Dict, traffic: Dict, seed: int) -> np.ndarray:
    """(pool_batches, batch, ctx) ADC codes, int16, from ``seed``."""
    n_b, b, ctx = traffic["pool_batches"], traffic["batch"], traffic["ctx"]
    g = cfg["input_grid"]
    wf, _, _ = cepc_waveform(seed, n_b * b, ctx, "val")
    codes = quantize_to_int(wf, g["f"], g["i"], g["signed"], "SAT")
    return codes.astype(traffic["input_dtype"]).reshape(n_b, b, ctx)


def build(cfg: Dict, params: Dict[str, torch.Tensor], ctx: int, device) -> Tuple:
    """``(engine, timings)``: the program's hybrid holding ``params``,
    lowered over ``ctx`` samples and built on kernel B4 behind its gate;
    ``timings`` holds the lowering's seconds and the build's own."""
    from repro_torch.core.lower import lower
    from repro_torch.models import pid
    from repro_torch.serve.api import EngineSpec, build as api_build

    layers = pid.build_pid_layers(window=cfg["window"], features=cfg["features"],
                                  hidden=cfg["hidden"], device=device,
                                  generator=torch.Generator().manual_seed(0))
    named = pid.pid_named_params(layers)
    if set(named) != set(params):
        raise KeyError(f"the program's parameters {sorted(named)} are not the "
                       f"benchmark's {sorted(params)}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(params[k])
    graph = pid.build_pid_graph(layers, n_samples=ctx)
    t0 = time.perf_counter()
    prog = lower(graph)
    lower_s = time.perf_counter() - t0
    built = api_build(prog, EngineSpec(engine="pallas", require="pallas"), device=device)
    timings = {"lower_s": lower_s, **{k: v for k, v in built.timings.items()
                                      if isinstance(v, float)}}
    return built.engine, timings
