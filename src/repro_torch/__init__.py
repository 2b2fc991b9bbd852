"""PyTorch/CUDA port of the HGQ-LUT system, beside the JAX package ``repro``.

The layout mirrors ``src/repro``: ``core/`` (quantizers, LUT layers, truth
tables, the DAIS IR, lowering and static analysis), ``kernels/`` (plain
PyTorch versions plus the hand-written Hopper kernels under ``csrc/``),
``nn/``, ``serve/`` and ``launch/``.  The package imports ``torch``, numpy
and the standard library only; nothing here imports ``jax`` or ``repro``.

Importing the package builds nothing and needs no GPU: the CUDA kernels are
compiled by ``kernels/build.py`` on their first launch.
"""
