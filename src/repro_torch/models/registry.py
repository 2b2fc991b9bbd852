"""Model registry: family -> model class (port of ``repro.models.registry``).

The decoder families (``lm``, ``moe``, ``vlm``) build a ``DecoderLM``, the
hybrid a ``ZambaHybrid`` (Zamba2), the SSM family an ``RWKV6LM`` and the
encoder-decoder a ``WhisperEncDec``; an unknown family raises, and no
family falls back to another.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig


def model_class(cfg: ArchConfig):
    """The model class of ``cfg``'s family (not built)."""
    if cfg.family in ("lm", "moe", "vlm"):
        from repro_torch.models.lm import DecoderLM
        return DecoderLM
    if cfg.family == "hybrid":
        from repro_torch.models.zamba import ZambaHybrid
        return ZambaHybrid
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import RWKV6LM
        return RWKV6LM
    if cfg.family == "encdec":
        from repro_torch.models.whisper import WhisperEncDec
        return WhisperEncDec
    raise ValueError(f"unknown family {cfg.family!r}")


def build_model(cfg: ArchConfig, mesh=None, *, device=None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg`` on ``device``, its parameters drawn from
    ``generator`` (on ``device="meta"``: shapes only, nothing drawn).  With
    no ``device`` it is built on the card, or on the device type of ``mesh``
    when one is given; with no card that raises, so the CPU is only ever
    asked for by name (``device="cpu"``).  With a ``mesh`` (a
    ``DeviceMesh``) the model runs the reference's sharding constraints;
    ``train/steps.py`` places its parameters on the mesh."""
    return model_class(cfg)(cfg, mesh, device=device, generator=generator)
