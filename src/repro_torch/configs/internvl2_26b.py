"""InternVL2-26B [arXiv:2404.16821]: InternViT + InternLM2 backbone.

Per the assignment the ViT frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (B, n_patches, d_model) which replace the first
``n_patches`` token embeddings of the LM (prefix-style multimodal fusion).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553,
    n_patches=256,
    mlp_type="glu", act="silu",
    fsdp=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, n_patches=8, q_chunk=16, fsdp=False)
