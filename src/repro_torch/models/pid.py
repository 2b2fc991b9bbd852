"""The paper's CEPC gas-detector PID hybrid (§V-F), port of
``repro.models.pid``.

One definition of the hybrid — a conventional (matmul) HGQ conv front, a
LUT-Conv stack, a time-independent LUT head, window-count accumulation —
shared by the training example (``examples/pid_hybrid.py``) and the serving
launcher (``launch/serve.py --model pid-hybrid``), so the architecture that
trains is the architecture that lowers and serves.

The 12-bit unsigned ADC input grid (``IN_F`` fractional + ``IN_I`` integer
bits, samples clamped to ``[0, 8)``) matches the waveform generator's clamp
(``data/synthetic.cepc_waveform``).

There is no ``init_pid_params``: the port's modules own their parameters,
drawn from the ``generator`` given to :func:`build_pid_layers`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.hgq_layers import HGQConv1D
from repro_torch.core.lower import GraphInput, ModelGraph, WindowSum
from repro_torch.core.lut_layers import LUTConv1D, LUTDense

WINDOW = 20          # samples per DAQ cycle (256-bit bus / 12-bit samples)
IN_F, IN_I = 9, 3    # 12-bit unsigned ADC grid: [0, 8) in 2**-9 steps
# the reference example's parameter dict keys, in layer order
PID_KEYS = ("front", "lc1", "lc2", "head")


def build_pid_layers(window: int = WINDOW, features: int = 8, hidden: int = 8,
                     *, device="cuda", generator: torch.Generator) -> Tuple:
    """(front, lc1, lc2, head) as the paper prescribes, weights drawn from
    ``generator`` in that order."""
    kw = dict(device=device, generator=generator)
    front = HGQConv1D(c_in=1, c_out=features, kernel=window, stride=window,
                      activation="relu", **kw)    # conventional conv front
    lc1 = LUTConv1D(c_in=features, c_out=8, kernel=3, padding="SAME",
                    hidden=hidden, **kw)
    lc2 = LUTConv1D(c_in=8, c_out=4, kernel=3, padding="SAME", hidden=hidden, **kw)
    head = LUTDense(4, 1, hidden=hidden, **kw)    # per-window count regressor
    return front, lc1, lc2, head


def pid_named_params(layers) -> Dict[str, torch.Tensor]:
    """The hybrid's trainable parameters keyed by the reference's tree paths
    (``front/w``, ``lc1/q_in/f``, ...), in layer and registration order."""
    return {f"{key}/{name.replace('.', '/')}": p
            for key, layer in zip(PID_KEYS, layers)
            for name, p in getattr(layer, "dense", layer).named_parameters()}


def build_pid_graph(layers, n_samples: int, in_f: int = IN_F,
                    in_i: int = IN_I) -> ModelGraph:
    """The lowerable graph: the layers + window accumulation over a fixed
    ``n_samples``-sample context (a multiple of the front window).  The
    lowered program maps one waveform context to its predicted total
    cluster count; ``core.lower.lower(graph)`` compiles it."""
    window = layers[0].kernel
    if n_samples % window:
        raise ValueError(f"context length {n_samples} is not a multiple of "
                         f"the {window}-sample DAQ window")
    return ModelGraph(
        input=GraphInput(shape=(n_samples, 1), f=in_f, i=in_i, signed=False),
        nodes=[*layers, WindowSum()])
