"""The serve API, port of ``repro.serve.api`` for a ``DaisProgram`` source.

``build(prog, spec, device=...)`` compiles the program to a serving engine
under an :class:`EngineSpec` — preferred lowering, dtype, the verify posture
and the require-flag that turns a path downgrade into a hard error — and
returns a :class:`BuiltEngine` with the attestation that justified serving
it.  Bundle and registry sources, the optimizer pass and the RTL gate wait
for later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.core.dais import DaisProgram
from repro_torch.kernels.lut_serve import (EngineRequirementError,
                                           compile_program, verify_engine)

_VERIFY_POLICIES = ("full", "skip")
_REQUIRE = (None, "fused", "pallas")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How to construct and qualify one serving engine.

    * ``engine`` — preferred lowering: ``"pallas"`` (the one-launch packed
      chain, kernel B4) or ``"fused"`` (per-stage PyTorch integer ops).
    * ``verify`` — ``"full"`` runs the bit-exactness gate
      (``verify_engine``) before the engine is returned; ``"skip"`` runs
      none.
    * ``require`` — ``"fused"`` / ``"pallas"``: a path downgrade raises
      :class:`EngineRequirementError` instead of serving at a lower tier.
    """

    engine: str = "fused"
    dtype: Optional[torch.dtype] = None
    verify: str = "full"
    n_random: int = 1024
    seed: int = 0
    require: Optional[str] = None

    def __post_init__(self):
        if self.verify not in _VERIFY_POLICIES:
            raise ValueError(f"verify must be one of {_VERIFY_POLICIES}, "
                             f"got {self.verify!r}")
        if self.require not in _REQUIRE:
            raise ValueError(f"require must be one of {_REQUIRE}, "
                             f"got {self.require!r}")


@dataclasses.dataclass(frozen=True)
class BuiltEngine:
    """A qualified engine: runtime, the program it runs, and its gate."""

    engine: object
    prog: DaisProgram
    attestation: Optional[dict]
    timings: Dict[str, float]


def _enforce(spec: EngineSpec, engine) -> None:
    why = engine.fuse_reason or "no downgrade reason recorded"
    if spec.require == "pallas" and engine.path != "pallas":
        raise EngineRequirementError(
            f"require='pallas': engine compiled on the {engine.path!r} "
            f"path, not the one-launch packed chain ({why})")
    if spec.require == "fused" and engine.path not in ("pallas", "fused"):
        raise EngineRequirementError(
            f"require='fused': engine compiled on the {engine.path!r} path "
            f"({why})")


def build(prog: DaisProgram, spec: Optional[EngineSpec] = None, *,
          device="cuda") -> BuiltEngine:
    """Compile ``prog`` on ``device`` and qualify it per ``spec``."""
    if not isinstance(prog, DaisProgram):
        raise TypeError(f"build() takes a DaisProgram, got {type(prog).__name__}")
    spec = spec or EngineSpec()
    timings: Dict[str, float] = {}
    t0 = time.monotonic()
    engine = compile_program(prog, device=device, dtype=spec.dtype,
                             engine=spec.engine)
    timings["compile_s"] = time.monotonic() - t0
    _enforce(spec, engine)
    att = None
    if spec.verify == "full":
        t0 = time.monotonic()
        att = verify_engine(engine, prog, n_random=spec.n_random,
                            seed=spec.seed)
        timings["gate_s"] = time.monotonic() - t0
    return BuiltEngine(engine=engine, prog=prog, attestation=att,
                       timings=timings)


__all__ = ["BuiltEngine", "EngineRequirementError", "EngineSpec", "build"]
