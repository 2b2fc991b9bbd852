"""Whisper-base [arXiv:2212.04356]: encoder-decoder; conv frontend is a STUB.

``input_specs()`` provides precomputed mel-frame embeddings
(B, enc_ctx, d_model); the encoder is bidirectional, the decoder is causal
with cross-attention.  Decode cells lower the decoder ``serve_step``.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865,
    n_enc_layers=6, enc_ctx=1500,
    norm_type="layernorm", mlp_type="mlp", act="gelu",
    tie_embeddings=True,
    quant="hgq",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, enc_ctx=32, q_chunk=16)
