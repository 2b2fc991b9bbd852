"""Architecture + shape configuration system (port of ``repro.configs.base``).

Every architecture registers an :class:`ArchConfig` through its own module
in ``src/repro_torch/configs/<id>.py`` (exact published dimensions, copied
as data from the reference) plus a ``smoke()`` reduction of the same family
for CPU tests.  Input-shape cells come from the shared SHAPES table;
``applicable_shapes`` encodes the skip rules (no decode for encoder-only,
sub-quadratic gate on ``long_500k``).

``fsdp`` and ``serve_fsdp`` (ZeRO sharding) act on a mesh only, through
the sharding rules (``parallel/sharding.py``, ``train/steps.py``).  Fields
kept so the configs read the same as the reference's:
``flash_remat`` (the reference's name for recomputing each attention
q-chunk in the backward; the port honours it as ``torch.utils.checkpoint``
per chunk), ``ce_remat`` (likewise per CE chunk) and ``lut_use_fused``
(LUT layers only; no LM config has one).  ``remat`` is a checkpoint per
layer in both packages.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # lm | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention flavour
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0              # sliding window size (local layers)
    global_period: int = 0       # gemma3: every Nth layer is global
    norm_type: str = "rmsnorm"
    nonparam_norm: bool = False  # olmo: non-parametric LN
    mlp_type: str = "glu"        # glu | mlp
    act: str = "silu"
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic
    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0           # zamba2: shared attn block period
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_ctx: int = 0              # precomputed frame embeddings length
    # VLM
    n_patches: int = 0
    # paper technique
    quant: str = "none"           # none | hgq
    lut_use_fused: bool = False   # LUT layers: fused B2/B3 train path
    # compute
    dtype: str = "bfloat16"
    q_chunk: int = 128
    remat: bool = True
    fsdp: bool = False            # mesh only: ZeRO-shard params/optimizer
    flash_remat: bool = True      # recompute attention probs in backward
    ce_remat: bool = True         # recompute CE-chunk logits in backward
    serve_fsdp: int = -1          # mesh only: serving sharding profile

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-context cell? (SSM/hybrid/local-attn)"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # every config has an autoregressive decoder


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "olmo_1b", "qwen3_14b", "gemma3_12b", "qwen15_05b", "zamba2_12b",
    "phi35_moe", "arctic_480b", "internvl2_26b", "rwkv6_16b", "whisper_base",
]

# paper-task model configs live alongside (not part of the 40-cell grid)
PAPER_TASKS = ["jsc_hlf", "jsc_plf_gnn", "tgc_hybrid", "cepc_pid"]


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return _env_overrides(mod.CONFIG)


def _env_overrides(cfg: ArchConfig) -> ArchConfig:
    """``REPRO_<FIELD>=value`` overrides of any field, as in the reference."""
    over = {}
    for f in dataclasses.fields(ArchConfig):
        v = os.environ.get(f"REPRO_{f.name.upper()}")
        if v is None:
            continue
        if f.type in ("bool", bool):
            over[f.name] = v not in ("0", "false", "False")
        elif f.type in ("int", int):
            over[f.name] = int(v)
        elif f.type in ("float", float):
            over[f.name] = float(v)
        else:
            over[f.name] = v
    return dataclasses.replace(cfg, **over) if over else cfg


def get_smoke(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.smoke()


def list_archs():
    return list(ARCH_IDS)


def applicable_shapes(cfg: ArchConfig) -> Tuple[str, ...]:
    """Skip rules -> which of the 4 cells this arch runs."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return tuple(out)
