"""Deterministic synthetic data of the paper tasks (port of
``repro.data.synthetic``; numpy only, the same numbers as the reference).

Every generator is a pure function of its seed and split, so any process can
regenerate any batch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


# --------------------------------------------------------- JSC HLF (paper V-C)
N_HLF_FEATURES = 16
N_JET_CLASSES = 5


def jsc_hlf(seed: int, n: int, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """16 jet-substructure-like features, 5 classes (q/g/W/Z/t analogue).

    Class-conditional Gaussian mixtures with nonlinear feature couplings so a
    small MLP reaches ~75% accuracy, the regime of the paper's Table II.
    """
    rng = _rng(seed, {"train": 0, "val": 1, "test": 2}[split])
    y = rng.integers(0, N_JET_CLASSES, size=n)
    # classes 2/3 share most of their center vector (W/Z confusion analogue)
    centers = _rng(seed, 99).normal(0, 0.85, size=(N_JET_CLASSES, N_HLF_FEATURES))
    centers[3] = centers[2] + _rng(seed, 98).normal(0, 0.30, N_HLF_FEATURES)
    x = centers[y] + rng.normal(0, 1.0, size=(n, N_HLF_FEATURES))
    # nonlinear couplings (mass-like, multiplicity-like composites)
    x[:, 0] = np.abs(x[:, 0]) + 0.5 * x[:, 1] ** 2
    x[:, 5] = np.tanh(x[:, 5]) * (1 + 0.3 * y)
    x[:, 10] = x[:, 10] * x[:, 11] * 0.5
    return x.astype(np.float32), y.astype(np.int32)
