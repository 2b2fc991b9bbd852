"""The public serve API, port of ``repro.serve.api``.

``build(source, spec, device=...)``
    *source* is anything engine-shaped — a :class:`DaisProgram`, a loaded
    :class:`~repro_torch.serve.artifact.LoadedArtifact`, or a bundle
    **path** — and :class:`EngineSpec` is the whole construction policy in
    one frozen value: preferred lowering, dtype, lane narrowing, the
    optimizer pass, the verify posture (full / cached / skip), the optional
    RTL gate and the require-flag that turns a path downgrade into a hard
    error.  Returns a :class:`BuiltEngine`: the engine on ``device``, the
    program oracle, the attestation that justified serving it, and bundle
    provenance.

``serve(models, spec, tier)``
    builds every named model through the same spec, registers the results
    in a fresh :class:`~repro_torch.serve.registry.ModelRegistry`, and
    returns a started :class:`~repro_torch.serve.tier.ServeTier`: artifacts
    on disk to a live multi-replica, multi-model service in one call.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import torch

from repro_torch.core.dais import DaisProgram
from repro_torch.kernels.lut_serve import (EngineRequirementError,
                                           compile_program, verify_engine)
from repro_torch.serve.artifact import LoadedArtifact, load_artifact
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.scheduler import ServeConfig
from repro_torch.serve.tier import ServeTier, TierConfig

_VERIFY_POLICIES = ("full", "cached", "skip")
_REQUIRE = (None, "fused", "pallas")


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How to construct and qualify one serving engine.

    * ``engine`` — preferred lowering: ``None`` or ``"fused"`` (per-stage
      PyTorch integer ops), ``"pallas"`` (the one-launch packed chain,
      kernel B4) or ``"groups"`` (the generic op-group runner).  Unavailable
      preferences degrade ``pallas -> fused -> generic``.
    * ``optimize`` — run dead-cell elimination (``core/opt.py``) on a fresh
      program before compiling; the gate then checks the optimized engine
      against the **unoptimized** interpreter, proving the pass.  Rejected
      for bundle sources (a bundle's stages and attestation cover the
      stored program — save an optimized bundle instead).
    * ``verify`` — ``"full"`` always runs the bit-exactness gate
      (``verify_engine``); ``"cached"`` (default) trusts a bundle's
      content-hash-protected stored attestation and runs the full gate
      otherwise; ``"skip"`` runs none.
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
    verify: str = "cached"
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
    ``optimize=True`` rewrote it).  ``attestation`` is the gate statistics
    that justified serving — ``None`` only under ``verify="skip"`` on a
    source with no stored attestation.  ``content_hash`` / ``source`` carry
    bundle provenance when the engine came from one.
    """

    engine: object
    prog: DaisProgram
    oracle: DaisProgram
    attestation: Optional[dict]
    content_hash: Optional[str] = None
    source: Optional[str] = None
    timings: Dict[str, object] = dataclasses.field(default_factory=dict)


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


def _with_rtl(att, prog, engine, oracle, spec, timings):
    """``att`` plus the three-way RTL attestation (``core/rtl.verify_rtl``)
    under ``"rtl"`` when ``spec.verify_rtl`` asks for it."""
    if not spec.verify_rtl:
        return att
    from repro_torch.core.rtl import verify_rtl

    att = dict(att or {})
    t0 = time.monotonic()
    att["rtl"] = verify_rtl(prog, oracle=oracle if oracle is not prog else None,
                            engine=engine, n_random=spec.n_random, seed=spec.seed)
    timings["rtl_s"] = time.monotonic() - t0
    return att


def build(source: Union[DaisProgram, LoadedArtifact, str],
          spec: Optional[EngineSpec] = None, *, device="cuda") -> BuiltEngine:
    """Compile ``source`` on ``device`` and qualify it per ``spec``.

    The gate's reference program (the oracle) is the source's own program;
    under ``optimize=True`` the engine serves the DCE'd program and the
    unoptimized one stays the oracle.
    """
    spec = spec or EngineSpec()
    timings: Dict[str, object] = {}

    path_str = None
    if isinstance(source, str):
        path_str = source
        t0 = time.monotonic()
        source = load_artifact(source)
        timings["load_s"] = time.monotonic() - t0

    if isinstance(source, LoadedArtifact):
        if spec.optimize:
            raise ValueError(
                "optimize=True applies at compile time and cannot rewrite "
                "an existing bundle (its stages and attestation cover the "
                "stored program); rebuild from the DaisProgram and save an "
                "optimized bundle instead")
        prog = source.prog
        t0 = time.monotonic()
        engine = compile_program(prog, device=device, dtype=spec.dtype,
                                 stages=source.stages, engine=spec.engine,
                                 packed=source.packed, narrow=spec.narrow)
        timings["compile_s"] = time.monotonic() - t0
        _enforce(spec, engine)
        stored = source.attestation
        if spec.verify == "skip" or (spec.verify == "cached" and stored):
            att = stored        # the content hash ties it to these bytes
        else:
            t0 = time.monotonic()
            att = verify_engine(engine, prog, n_random=spec.n_random,
                                seed=spec.seed)
            timings["gate_s"] = time.monotonic() - t0
        att = _with_rtl(att, prog, engine, prog, spec, timings)
        return BuiltEngine(engine=engine, prog=prog, oracle=prog,
                           attestation=att,
                           content_hash=source.content_hash,
                           source=path_str, timings=timings)

    if not isinstance(source, DaisProgram):
        raise TypeError(
            f"build() takes a DaisProgram, LoadedArtifact, or bundle path; "
            f"got {type(source).__name__}")

    prog = oracle = source
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
    if spec.verify in ("full", "cached"):
        t0 = time.monotonic()
        att = verify_engine(engine, oracle, n_random=spec.n_random,
                            seed=spec.seed)
        timings["gate_s"] = time.monotonic() - t0
    att = _with_rtl(att, prog, engine, oracle, spec, timings)
    return BuiltEngine(engine=engine, prog=prog, oracle=oracle,
                       attestation=att, timings=timings)


def serve(models: Dict[str, Union[DaisProgram, LoadedArtifact, str]],
          spec: Optional[EngineSpec] = None,
          tier: Optional[TierConfig] = None,
          *, start: bool = True, device="cuda") -> ServeTier:
    """Artifacts in, live service out: build + register + start the tier.

    ``models`` maps serving names to engine sources (programs, loaded
    bundles, or bundle paths); every one is built on ``device`` through the
    same ``spec``, registered (with its content hash and attestation) into a
    fresh :class:`ModelRegistry`, and served by a :class:`ServeTier` under
    ``tier`` (default: 2 replicas, work stealing, default
    :class:`ServeConfig`).  The caller owns the tier: ``submit`` into it,
    hot-``swap`` models through ``tier.registry``, ``stop()`` it when done
    (it is also a context manager).
    """
    if not models:
        raise ValueError("serve() needs at least one model")
    return tier_from_built({name: build(src, spec, device=device)
                            for name, src in models.items()},
                           tier, start=start)


def tier_from_built(built_models: Dict[str, BuiltEngine],
                    tier: Optional[TierConfig] = None,
                    *, start: bool = True) -> ServeTier:
    """A tier (started unless ``start=False``) over engines the caller
    already built and gated."""
    registry = ModelRegistry()
    for name, b in built_models.items():
        registry.register(name, b.engine, b.prog, content_hash=b.content_hash,
                          attestation=b.attestation)
    t = ServeTier(registry, tier or TierConfig())
    return t.start() if start else t


__all__ = [
    "BuiltEngine", "EngineRequirementError", "EngineSpec", "ModelRegistry",
    "ServeConfig", "ServeTier", "TierConfig", "build", "serve",
    "tier_from_built",
]
