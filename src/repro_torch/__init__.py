"""PyTorch/CUDA port of the HGQ-LUT system, beside the JAX package ``repro``.

The layout mirrors ``src/repro``: ``core/`` (quantizers, LUT layers, truth
tables, the DAIS IR, lowering and static analysis), ``kernels/`` (plain
PyTorch versions plus the hand-written Hopper kernels under ``csrc/``),
``nn/``, ``optim/``, ``train/`` (the train step and the chunked loop, eager
or one CUDA graph per chunk), ``data/`` (synthetic data and the prefetching
input pipeline), ``ckpt/`` (checkpoints in the reference's layout),
``serve/`` and ``launch/``.  The package imports ``torch``, numpy
and the standard library only; nothing here imports ``jax`` or ``repro``.

Importing the package builds nothing and needs no GPU: the CUDA kernels are
compiled by ``kernels/build.py`` on their first launch.
"""
