"""Serving subsystem, port of ``repro.serve``: the compiled integer artifact
as a long-running service on the card.

* :mod:`repro_torch.serve.api` — the façade: ``EngineSpec`` +
  ``build(source, spec)`` (program, loaded bundle or bundle path → qualified
  engine + attestation) and ``serve(models, spec, tier)``, the one-call path
  to a live service;
* :mod:`repro_torch.serve.scheduler` — async micro-batching: single requests
  coalesced into padded power-of-two batches under a latency deadline, one
  engine call (one B4 launch) a batch, scattered back to futures;
* :mod:`repro_torch.serve.tier` — a pool of work-stealing replicas with
  admission control and SLO deadline buckets over a multi-model registry
  (:mod:`repro_torch.serve.registry`) with hot-swap;
* :mod:`repro_torch.serve.artifact` — content-hashed ``.npz`` bundles in the
  reference's wire format, so a restart cold-starts without re-lowering.

``launch/serve.py --serve-loop`` / ``--replicas`` / ``--models`` are the
entry points.  ``BatcherConfig`` and ``artifact.build_engine`` are
deprecated shims over ``ServeConfig`` and ``api.build``.
"""

from repro_torch.serve.api import (BuiltEngine, EngineRequirementError,
                                   EngineSpec, build, serve, tier_from_built)
from repro_torch.serve.artifact import (ArtifactError, LoadedArtifact,
                                        build_engine, load_artifact,
                                        save_artifact)
from repro_torch.serve.registry import ModelInfo, ModelRegistry, RegistryError
from repro_torch.serve.scheduler import (BatcherConfig, InterpreterBackend,
                                         MicroBatcher, RejectedError,
                                         SchedulerStats, ServeConfig,
                                         bucket_ladder, drive_open_loop)
from repro_torch.serve.tier import ServeTier, TierConfig, TierStats

__all__ = [
    "ArtifactError", "BatcherConfig", "BuiltEngine", "EngineRequirementError",
    "EngineSpec", "InterpreterBackend", "LoadedArtifact", "MicroBatcher",
    "ModelInfo", "ModelRegistry", "RegistryError", "RejectedError",
    "SchedulerStats", "ServeConfig", "ServeTier", "TierConfig", "TierStats",
    "build", "build_engine", "drive_open_loop", "load_artifact",
    "save_artifact", "serve", "tier_from_built", "bucket_ladder",
]
