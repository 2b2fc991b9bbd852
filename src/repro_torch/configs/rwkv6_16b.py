"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent decay."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6_16b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64
    d_ff=7168, vocab=65536,
    norm_type="layernorm",
    quant="hgq",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
        d_ff=256, vocab=256, q_chunk=16)
