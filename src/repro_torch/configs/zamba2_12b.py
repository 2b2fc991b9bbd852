"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block.

38 Mamba2 (SSD) layers; a single *shared* attention+MLP block is applied
every ``attn_every`` layers (parameter reuse is Zamba's signature trick).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2_12b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, attn_every=6,
    mlp_type="glu", act="gelu",
    quant="hgq",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=8, attn_every=2, q_chunk=16)
