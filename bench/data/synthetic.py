"""Frozen traffic generators of the benchmark.

Copied from ``src/repro_torch/data/synthetic.py`` (``_rng``, ``jsc_hlf``,
``cepc_waveform``) and ``src/repro_torch/core/quant.py``
(``quantize_to_int``, ``int_to_float``) at commit
1e35da467a58367bd43292fb4c37d72db1ec41f5, and owned by the benchmark from
then on: a change to the program's generators does not change what the
benchmark feeds it.  Numpy only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

N_HLF_FEATURES = 16
N_JET_CLASSES = 5


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


def jsc_hlf(seed: int, n: int, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """16 jet-substructure-like features, 5 classes (q/g/W/Z/t analogue):
    class-conditional Gaussian mixtures with nonlinear feature couplings."""
    rng = _rng(seed, {"train": 0, "val": 1, "test": 2}[split])
    y = rng.integers(0, N_JET_CLASSES, size=n)
    centers = _rng(seed, 99).normal(0, 0.85, size=(N_JET_CLASSES, N_HLF_FEATURES))
    centers[3] = centers[2] + _rng(seed, 98).normal(0, 0.30, N_HLF_FEATURES)
    x = centers[y] + rng.normal(0, 1.0, size=(n, N_HLF_FEATURES))
    x[:, 0] = np.abs(x[:, 0]) + 0.5 * x[:, 1] ** 2
    x[:, 5] = np.tanh(x[:, 5]) * (1 + 0.3 * y)
    x[:, 10] = x[:, 10] * x[:, 11] * 0.5
    return x.astype(np.float32), y.astype(np.int32)


def cepc_waveform(seed: int, n: int, length: int = 3000,
                  split: str = "train") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drift-chamber-like waveforms with primary-cluster impulse trains:
    (waveform (n, length), window counts (n, length // 20), species)."""
    rng = _rng(seed, 30 + {"train": 0, "val": 1, "test": 2}[split])
    species = rng.integers(0, 2, size=n)
    dens = np.where(species == 1, 0.012, 0.009)
    wf = rng.normal(0, 0.05, size=(n, length)).astype(np.float32)
    counts = np.zeros((n, length // 20), np.float32)
    tail = np.exp(-np.arange(40) / 8.0).astype(np.float32)
    for i in range(n):
        n_cl = rng.poisson(dens[i] * length)
        pos = np.sort(rng.integers(0, length - 45, size=n_cl))
        amp = rng.uniform(0.4, 1.2, size=n_cl)
        for p_, a_ in zip(pos, amp):
            wf[i, p_:p_ + 40] += a_ * tail
            counts[i, p_ // 20] += 1.0
    wf = np.clip(wf, 0.0, 8.0 - 2 ** -9)
    return wf, counts, species.astype(np.int32)


def quantize_to_int(x: np.ndarray, f, i, signed: bool, overflow: str) -> np.ndarray:
    """The integer code of ``x`` on the (f, i) grid: ``round(x * 2**f)``
    (half to even) wrapped or clipped into the representable range."""
    f = np.asarray(f, dtype=np.int64)
    i = np.asarray(i, dtype=np.int64)
    width = f + i + (1 if signed else 0)
    code = np.round(np.asarray(x, dtype=np.float64) * np.exp2(f)).astype(np.int64)
    n_codes = np.where(width > 0, 2 ** np.maximum(width, 0), 1)
    lo = np.where(signed, -(n_codes // 2), 0)
    hi = lo + n_codes - 1
    if overflow == "SAT":
        code = np.clip(code, lo, hi)
    else:
        code = lo + np.mod(code - lo, n_codes)
    return np.where(width > 0, code, 0)


def int_to_float(code: np.ndarray, f) -> np.ndarray:
    return np.asarray(code, dtype=np.float64) * np.exp2(-np.asarray(f, dtype=np.float64))
