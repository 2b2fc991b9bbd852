"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: dense LM with QKV bias."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen15_05b", family="lm",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab=151936,
    qkv_bias=True,
    mlp_type="glu", act="silu",
    tie_embeddings=True,
    quant="hgq",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, q_chunk=16)
