"""Gemma3-12B [hf:google/gemma-3-12b-pt]: 5:1 local:global attention, 128k ctx.

Every 6th layer is global; local layers use a 1024-token sliding window —
which is what makes the 500k-decode cell tractable (only the 8 global layers
hold full-length KV).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_12b", family="lm",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256,
    window=1024, global_period=6, rope_theta=1e6,
    mlp_type="glu", act="gelu",
    tie_embeddings=True,
    fsdp=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=256, window=8, global_period=2,
        q_chunk=16, fsdp=False)
