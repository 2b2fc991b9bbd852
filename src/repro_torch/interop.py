"""Carrying parameters between the reference and the port as numpy.

The reference's ``LUTDense.init`` / trained parameter dict — ``w0``, ``b0``,
``w_out`` (C_in, C_out, H), ``b_out``, nested ``q_in`` / ``q_out`` with
``f`` and ``i``, and the BN ``bn_scale`` / ``bn_bias`` / ``bn_mean`` /
``bn_var`` — crosses as a dict of numpy arrays with the same keys and
shapes.  Seeds cannot carry weights across, because ``jax.random`` and
torch's generators differ.  DAIS programs cross as
``DaisProgram.to_arrays()`` / ``from_arrays()`` (wire format v2), which the
port reads unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.lut_layers import LUTDense

_QUANTIZERS = ("q_in", "q_out")


def _entries(module: LUTDense):
    """(key, sub-key or None, tensor) for every reference parameter."""
    out = []
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        key, _, sub = name.partition(".")
        out.append((key, sub or None, t))
    return out


def lut_dense_params_from_numpy(module: LUTDense, d: Dict) -> LUTDense:
    """Load a reference parameter dict (numpy leaves) into ``module``.

    Keys and shapes must match the module's exactly; returns the module.
    """
    want = {(k, s) for k, s, _ in _entries(module)}
    got = {(k, s) for k, v in d.items()
           for s in (v if k in _QUANTIZERS else [None])}
    if want != got:
        raise KeyError(f"parameter keys differ: missing {sorted(want - got, key=str)}, "
                       f"unexpected {sorted(got - want, key=str)}")
    with torch.no_grad():
        for key, sub, t in _entries(module):
            a = np.array(d[key][sub] if sub else d[key], np.float32)
            if a.shape != tuple(t.shape):
                raise ValueError(f"{key}{'/' + sub if sub else ''}: shape "
                                 f"{a.shape} != {tuple(t.shape)}")
            t.copy_(torch.as_tensor(a))
    return module


def lut_dense_params_to_numpy(module: LUTDense) -> Dict:
    """The module's parameters as a reference-shaped dict of numpy arrays."""
    d: Dict = {}
    for key, sub, t in _entries(module):
        a = t.detach().cpu().numpy().copy()
        if sub:
            d.setdefault(key, {})[sub] = a
        else:
            d[key] = a
    return d
