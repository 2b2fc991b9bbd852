"""Model registry: family -> model class (port of ``repro.models.registry``).

The decoder families (``lm``, ``moe``, ``vlm``) build a ``DecoderLM``.  The
hybrid (Zamba2), SSM (RWKV-6) and encoder-decoder (Whisper) families are
the next slice of the port and raise here; no family falls back to another.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig

NOT_PORTED = {"hybrid": "ZambaHybrid", "ssm": "RWKV6LM", "encdec": "WhisperEncDec"}


def build_model(cfg: ArchConfig, *, device="cpu",
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg`` on ``device``, its parameters drawn from
    ``generator``."""
    if cfg.family in ("lm", "moe", "vlm"):
        from repro_torch.models.lm import DecoderLM
        return DecoderLM(cfg, device=device, generator=generator)
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family ({NOT_PORTED[cfg.family]}) is not "
            f"ported yet (ROADMAP A9b)")
    raise ValueError(f"unknown family {cfg.family!r}")
