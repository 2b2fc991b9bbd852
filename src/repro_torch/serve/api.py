"""The serve API, port of ``repro.serve.api`` for a ``DaisProgram`` source.

``build(prog, spec, device=...)`` compiles the program to a serving engine
under an :class:`EngineSpec` — preferred lowering, dtype, lane narrowing,
the optimizer pass, the verify posture, the optional RTL gate and the
require-flag that turns a path downgrade into a hard error — and returns a
:class:`BuiltEngine` with the attestation that justified serving it.
Bundle and registry sources (``verify="cached"``) and ``serve`` wait for
later slices (ROADMAP A4, A5).
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

    * ``engine`` — preferred lowering: ``None`` or ``"fused"`` (per-stage
      PyTorch integer ops), ``"pallas"`` (the one-launch packed chain,
      kernel B4) or ``"groups"`` (the generic op-group runner).  Unavailable
      preferences degrade ``pallas -> fused -> generic``.
    * ``optimize`` — run dead-cell elimination (``core/opt.py``) on the
      program before compiling; the gate then checks the optimized engine
      against the **unoptimized** interpreter, proving the pass.
    * ``verify`` — ``"full"`` runs the bit-exactness gate
      (``verify_engine``) before the engine is returned; ``"skip"`` runs
      none.
    * ``verify_rtl`` — additionally emit Verilog and assert the three-way
      RTL == interpreter == engine attestation (``core/rtl.verify_rtl``).
    * ``require`` — ``"fused"`` / ``"pallas"``: a path downgrade raises
      :class:`EngineRequirementError` instead of serving at a lower tier.
    * ``narrow`` — size the engine dtype from the proven ``engine_width``
      and narrow B4's table lanes to the proven value ranges; ``False``
      sizes from ``required_width()`` and packs full rows (the baseline).
    """

    engine: Optional[str] = "fused"
    dtype: Optional[torch.dtype] = None
    optimize: bool = False
    verify: str = "full"
    verify_rtl: bool = False
    n_random: int = 1024
    seed: int = 0
    require: Optional[str] = None
    narrow: bool = True

    def __post_init__(self):
        if self.verify not in _VERIFY_POLICIES:
            raise ValueError(f"verify must be one of {_VERIFY_POLICIES}, "
                             f"got {self.verify!r}")
        if self.require not in _REQUIRE:
            raise ValueError(f"require must be one of {_REQUIRE}, "
                             f"got {self.require!r}")


@dataclasses.dataclass(frozen=True)
class BuiltEngine:
    """A qualified engine: runtime, the program it runs, and its gate.

    ``prog`` is the program the engine executes; ``oracle`` the program the
    gate compared against (differs from ``prog`` exactly when
    ``optimize=True`` rewrote it).
    """

    engine: object
    prog: DaisProgram
    oracle: DaisProgram
    attestation: Optional[dict]
    timings: Dict[str, object]


def _enforce(spec: EngineSpec, engine) -> None:
    why = engine.fuse_reason or "no downgrade reason recorded"
    if spec.require == "pallas" and engine.path != "pallas":
        raise EngineRequirementError(
            f"require='pallas': engine compiled on the {engine.path!r} "
            f"path, not the one-launch packed chain ({why})")
    if spec.require == "fused" and engine.path not in ("pallas", "fused"):
        raise EngineRequirementError(
            f"require='fused': engine compiled on the generic "
            f"{engine.path!r} path ({why})")


def build(prog: DaisProgram, spec: Optional[EngineSpec] = None, *,
          device="cuda") -> BuiltEngine:
    """Compile ``prog`` on ``device`` and qualify it per ``spec``.

    The gate's reference program (the oracle) is ``prog`` itself; under
    ``optimize=True`` the engine serves the DCE'd program and the
    unoptimized ``prog`` stays the oracle.
    """
    if not isinstance(prog, DaisProgram):
        raise TypeError(f"build() takes a DaisProgram, got {type(prog).__name__}")
    spec = spec or EngineSpec()
    timings: Dict[str, object] = {}
    oracle = prog
    if spec.optimize:
        from repro_torch.core.opt import eliminate_dead_cells
        t0 = time.monotonic()
        prog, report = eliminate_dead_cells(prog)
        timings["dce_s"] = time.monotonic() - t0
        timings["dce_summary"] = report.summary()
    t0 = time.monotonic()
    engine = compile_program(prog, device=device, dtype=spec.dtype,
                             engine=spec.engine, narrow=spec.narrow)
    timings["compile_s"] = time.monotonic() - t0
    _enforce(spec, engine)
    att = None
    if spec.verify == "full":
        t0 = time.monotonic()
        att = verify_engine(engine, oracle, n_random=spec.n_random,
                            seed=spec.seed)
        timings["gate_s"] = time.monotonic() - t0
    if spec.verify_rtl:
        att = dict(att or {})
        t0 = time.monotonic()
        att["rtl"] = _rtl_attest(prog, engine, oracle, spec)
        timings["rtl_s"] = time.monotonic() - t0
    return BuiltEngine(engine=engine, prog=prog, oracle=oracle,
                       attestation=att, timings=timings)


def _rtl_attest(prog, engine, oracle, spec: EngineSpec) -> dict:
    from repro_torch.core.rtl import verify_rtl
    return verify_rtl(prog, oracle=oracle if oracle is not prog else None,
                      engine=engine, n_random=spec.n_random, seed=spec.seed)


__all__ = ["BuiltEngine", "EngineRequirementError", "EngineSpec", "build"]
