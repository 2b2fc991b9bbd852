"""Deterministic synthetic data of the paper tasks and the LM stream (port
of ``repro.data.synthetic``; numpy only, the same numbers as the reference).

Every generator is a pure function of its seed and split, so any process can
regenerate any batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, host]))


# ------------------------------------------------------------------ LM text
def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             host: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Host-local slice of the global batch: (batch/n_hosts, seq) tokens+labels.

    A Zipf unigram mixture with an induced bigram ("grammar": x_{t+1}
    depends on x_t), so the CE loss has learnable signal; a pure function
    of (seed, step, host)."""
    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    if batch % n_hosts:
        raise ValueError(f"global batch {batch} is not divisible by "
                         f"n_hosts {n_hosts}; remainder rows would be "
                         f"silently dropped")
    local = batch // n_hosts
    rng = _rng(seed, step, host)
    base = rng.zipf(1.3, size=(local, seq)).astype(np.int64) % vocab
    shiftd = (base * 31 + 7) % vocab
    mask = rng.random((local, seq)) < 0.5
    tokens = np.where(mask, base, np.roll(shiftd, 1, axis=1)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = 0
    return {"tokens": tokens, "labels": labels}


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


# --------------------------------------------------------------- JSC PLF set
def jsc_plf(seed: int, n: int, n_particles: int = 32, n_features: int = 16,
            split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """(N, F) padded particle clouds with class-dependent (pT, η, φ) shapes."""
    rng = _rng(seed, 10 + {"train": 0, "val": 1, "test": 2}[split])
    y = rng.integers(0, N_JET_CLASSES, size=n)
    n_real = rng.integers(n_particles // 4, n_particles + 1, size=n)
    pt = rng.exponential(1.0 + 0.4 * y[:, None], size=(n, n_particles))
    width = 0.3 + 0.15 * (y[:, None] % 3)
    eta = rng.normal(0, width, size=(n, n_particles))
    phi = rng.normal(0, width, size=(n, n_particles))
    feats = [pt, eta, phi]
    extra = rng.normal(0, 1, size=(n, n_particles, max(n_features - 3, 0)))
    extra[..., 0::2] *= (0.5 + 0.2 * y[:, None, None])
    x = np.concatenate([np.stack(feats, -1), extra], axis=-1)[:, :, :n_features]
    mask = np.arange(n_particles)[None, :] < n_real[:, None]
    x = np.where(mask[..., None], x, 0.0)  # zero-padding, as in the dataset
    order = np.argsort(-np.where(mask, pt, -1.0), axis=1)  # padded slots last
    x = np.take_along_axis(x, order[..., None], axis=1)
    return x.astype(np.float32), y.astype(np.int32)


# -------------------------------------------------------------- TGC tracking
def tgc_muon(seed: int, n: int, split: str = "train") -> Tuple[np.ndarray, np.ndarray]:
    """7×50 binary hit maps with a linear-track angle target (mrad)."""
    rng = _rng(seed, 20 + {"train": 0, "val": 1, "test": 2}[split])
    angle = rng.uniform(-30.0, 30.0, size=n)              # mrad, paper cut-off
    layers = np.arange(7)[None, :]
    x0 = rng.uniform(10, 40, size=(n, 1))
    hit_pos = x0 + angle[:, None] * 0.3 * layers + rng.normal(0, 0.6, (n, 7))
    idx = np.clip(np.round(hit_pos), 0, 49).astype(np.int64)
    hits = np.zeros((n, 7, 50), np.float32)
    hits[np.arange(n)[:, None], layers, idx] = 1.0
    noise = rng.random((n, 7, 50)) < 0.02
    hits = np.maximum(hits, noise.astype(np.float32))
    return hits.reshape(n, 350), angle.astype(np.float32)


# ------------------------------------------------------------- CEPC PID wave
def cepc_waveform(seed: int, n: int, length: int = 3000,
                  split: str = "train") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drift-chamber-like waveforms with primary-cluster impulse trains.

    Returns (waveform (n, length), window_counts (n, length//20), species).
    Kaons and pions differ in cluster density: the separation-power
    observable of the paper's PID task (§V-F).
    """
    rng = _rng(seed, 30 + {"train": 0, "val": 1, "test": 2}[split])
    species = rng.integers(0, 2, size=n)                   # 0=pion, 1=kaon
    dens = np.where(species == 1, 0.012, 0.009)            # clusters / sample
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
    wf = np.clip(wf, 0.0, 8.0 - 2 ** -9)                   # the ADC clamp
    return wf, counts, species.astype(np.int32)
