"""Cross-cutting forward outputs of the port's layers.

A layer's ``forward(x)`` returns ``(y, Aux)``.  ``Aux`` carries the scalars
the training loss adds (EBOPs for the β-regulariser, auxiliary losses) and
non-gradient state updates (batch-norm moving stats), as in ``repro.nn.base``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class Aux:
    ebops: torch.Tensor | float = 0.0
    aux_loss: torch.Tensor | float = 0.0
    updates: Dict[str, Any] = dataclasses.field(default_factory=dict)
