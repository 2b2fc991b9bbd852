"""The gradients and error-feedback states each pod holds in the cross-pod
case of ``tests/test_torch_mesh.py`` (numpy only: both the port's ``gloo``
ranks and the reference's ``shard_map`` read them)."""

import numpy as np


def pod_grads(pod: int):
    rng = np.random.default_rng(100 + pod)
    return {"a": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "b": {"c": rng.normal(0, 3, (7,)).astype(np.float32)}}


def pod_errs(pod: int):
    rng = np.random.default_rng(200 + pod)
    return {"a": rng.normal(0, 1e-3, (6, 5)).astype(np.float32),
            "b": {"c": rng.normal(0, 1e-3, (7,)).astype(np.float32)}}
