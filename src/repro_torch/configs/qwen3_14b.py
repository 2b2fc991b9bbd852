"""Qwen3-14B [hf:Qwen/Qwen3-14B family]: dense GQA LM with qk-norm."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_14b", family="lm",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    mlp_type="glu", act="silu",
    fsdp=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=128, vocab=256, q_chunk=16, fsdp=False)
