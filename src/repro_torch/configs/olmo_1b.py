"""OLMo-1B [arXiv:2402.00838]: dense LM with non-parametric LayerNorm."""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo_1b", family="lm",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=50304,
    norm_type="layernorm", nonparam_norm=True,
    mlp_type="glu", act="silu",
    tie_embeddings=True,
    quant="hgq",            # paper technique: HGQ QAT on all projections
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, q_chunk=16)
