"""Parameter definitions: one source of truth for shapes and init (port of
``repro.nn.params``).

Every model builds a nested dict of :class:`PDef` (shape + logical axis
names + initializer); :func:`init_params` materialises it with the
reference's distributions, :func:`param_shapes` gives it as ``meta``
tensors (nothing drawn or stored: the dry-run builds any width this way)
and :func:`count_params` sums its sizes.  The logical axes feed the
sharding rules (``parallel/sharding.py``).  ``torch.Generator``
and ``jax.random`` give different numbers from one seed: parameters cross
between the packages as numpy (``interop.lm_params_*``), never by seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis name per dim
    init: str = "normal"                     # normal | zeros | ones | uniform | const
    scale: float = 1.0                       # stddev multiplier (normal)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def flat_defs(defs, prefix: str = "") -> Dict[str, PDef]:
    """The leaves of a nested PDef dict by ``/``-joined path, in the order
    the dict gives them (the reference's paths: ``blocks/wq``)."""
    if isinstance(defs, PDef):
        return {prefix: defs}
    out: Dict[str, PDef] = {}
    for key, sub in defs.items():
        out.update(flat_defs(sub, f"{prefix}/{key}" if prefix else key))
    return out


def init_tensor(d: PDef, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One materialised parameter: normal × scale × fan_in^-½ with fan_in =
    ``shape[-2]`` (``shape[-1]`` for a vector), or zeros / ones /
    uniform(-scale, scale) / const(scale).  Random values are drawn on the
    generator's device (a CUDA generator draws a full-width model in
    milliseconds; a CPU one gives the same values whatever ``device`` is),
    then moved to ``device``.  On ``device="meta"`` nothing is drawn or
    stored: the tensor has the shape and dtype alone."""
    if torch.device(device).type == "meta":
        return torch.empty(d.shape, dtype=d.dtype, device="meta")
    gdev = generator.device if generator is not None else torch.device("cpu")
    if d.init == "zeros":
        t = torch.zeros(d.shape, dtype=d.dtype, device=device)
    elif d.init == "ones":
        t = torch.ones(d.shape, dtype=d.dtype, device=device)
    elif d.init == "normal":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale * fan_in ** -0.5
        t = (torch.randn(d.shape, generator=generator, device=gdev) * std).to(d.dtype)
    elif d.init == "uniform":
        t = (torch.rand(d.shape, generator=generator, device=gdev) * (2 * d.scale)
             - d.scale).to(d.dtype)
    elif d.init == "const":
        t = torch.full(d.shape, d.scale, dtype=d.dtype, device=device)
    else:
        raise ValueError(d.init)
    return t.to(device)


def init_params(defs, generator: Optional[torch.Generator], device) -> Dict[str, Any]:
    """Materialise ``defs`` (a nested dict of PDefs) into the same nesting of
    tensors on ``device``."""
    if isinstance(defs, PDef):
        return init_tensor(defs, generator, device)
    return {k: init_params(v, generator, device) for k, v in defs.items()}


def param_shapes(defs) -> Any:
    """``defs`` as the same nesting of ``meta`` tensors of each PDef's shape
    and dtype (the reference's ``ShapeDtypeStruct`` tree)."""
    return init_params(defs, None, "meta")


def count_params(defs) -> int:
    return int(sum(np.prod(d.shape) for d in flat_defs(defs).values()))
