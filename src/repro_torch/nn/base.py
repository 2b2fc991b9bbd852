"""Cross-cutting forward outputs of the port's layers (port of ``repro.nn.base``).

A layer's ``forward(x)`` returns ``(y, Aux)``.  ``Aux`` carries the scalars
the training loss adds (EBOPs for the β-regulariser, auxiliary losses) and
non-gradient state updates (batch-norm moving stats) that the train step
writes back into the layers after the optimizer.
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

    @staticmethod
    def zero(device="cpu") -> "Aux":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return Aux(ebops=z, aux_loss=z.clone())


def merge_aux(*auxes: Aux) -> Aux:
    """Sum EBOPs / aux losses and union state updates."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32)
    ebops = sum(f32(a.ebops) for a in auxes) if auxes else 0.0
    aux_loss = sum(f32(a.aux_loss) for a in auxes) if auxes else 0.0
    updates: Dict[str, Any] = {}
    for a in auxes:
        updates.update(a.updates)
    return Aux(ebops=ebops, aux_loss=aux_loss, updates=updates)


def scoped_updates(scope: str, aux: Aux) -> Aux:
    """Prefix the state-update paths of ``aux`` with ``scope/``."""
    return Aux(ebops=aux.ebops, aux_loss=aux.aux_loss,
               updates={f"{scope}/{k}": v for k, v in aux.updates.items()})
