"""Snowflake Arctic (480B) [hf:Snowflake/snowflake-arctic-base].

128 experts top-2 MoE with a parallel dense-residual GLU branch.  The
largest assigned arch: parameters + Adam state ZeRO-shard over the full
(pod × data × model) fleet (fsdp=True), experts over `model` (EP).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic_480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, top_k=2, dense_residual=True,
    mlp_type="glu", act="silu",
    fsdp=True,
    serve_fsdp=0,   # inference: EP over model + expert-FFN TP over data —
    #                 no ZeRO gathers (EXPERIMENTS.md §Perf hillclimb #2)
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, n_experts=4, q_chunk=16, fsdp=False)
