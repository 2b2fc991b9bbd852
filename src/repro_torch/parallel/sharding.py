"""Request-batch padding, port of ``repro.parallel.sharding.pad_batch``.

The reference's logical-axis sharding rules and ``replica_meshes`` are mesh
code and are not ported: on one card the serving tier's replicas
time-multiplex, which is the reference's own behaviour on one device.
"""

from __future__ import annotations

import numpy as np


def pad_batch(x, n_rows: int):
    """Zero-pad dim 0 of a host batch up to ``n_rows``.

    The serving scheduler coalesces requests into power-of-two buckets so
    kernel B4 sees a few batch sizes only; this is the padding step (zero
    codes are always valid inputs — the integer engines accept any in-range
    code and padded rows are dropped at scatter time).
    """
    if x.shape[0] > n_rows:
        raise ValueError(f"batch of {x.shape[0]} rows does not fit a "
                         f"{n_rows}-row bucket")
    if x.shape[0] == n_rows:
        return x
    pad = [(0, n_rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad)
