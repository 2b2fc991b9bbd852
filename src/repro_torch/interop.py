"""Carrying parameters between the reference and the port as numpy.

The reference's ``LUTDense.init`` / trained parameter dict — ``w0``, ``b0``,
``w_out`` (C_in, C_out, H), ``b_out``, nested ``q_in`` / ``q_out`` with
``f`` and ``i``, and the BN ``bn_scale`` / ``bn_bias`` / ``bn_mean`` /
``bn_var`` — crosses as a dict of numpy arrays with the same keys and
shapes.  Seeds cannot carry weights across, because ``jax.random`` and
torch's generators differ.  DAIS programs cross as
``DaisProgram.to_arrays()`` / ``from_arrays()`` (wire format v2), which the
port reads unchanged.

A stack crosses as ``{"l0": layer dict, "l1": ...}``.  The Adam state
crosses as the reference's ``{"m": stack dict, "v": stack dict, "step"}``;
the reference keeps moments for the BN ``bn_mean`` / ``bn_var`` too, which
are buffers in the port and always zero in the reference (their gradient is
zero), so they are dropped on the way in and written as zeros on the way out.
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


def stack_params_from_numpy(layers, d: Dict):
    """Load a reference stack dict (``{"l0": ..., "l1": ...}``) into ``layers``."""
    if set(d) != {f"l{k}" for k in range(len(layers))}:
        raise KeyError(f"stack keys {sorted(d)} do not match {len(layers)} layers")
    for k, layer in enumerate(layers):
        lut_dense_params_from_numpy(layer, d[f"l{k}"])
    return layers


def stack_params_to_numpy(layers) -> Dict:
    return {f"l{k}": lut_dense_params_to_numpy(layer) for k, layer in enumerate(layers)}


def _path(k: int, key: str, sub) -> str:
    return f"l{k}/{key}" + (f"/{sub}" if sub else "")


def opt_state_from_numpy(layers, d: Dict) -> Dict:
    """The reference's Adam state as the port's (flat, reference paths)."""
    from repro_torch.train.steps import named_params

    params = named_params(layers)
    device = next(iter(params.values())).device
    out = {"m": {}, "v": {}, "step": torch.tensor(int(np.asarray(d["step"])),
                                                  dtype=torch.int32, device=device)}
    for k, layer in enumerate(layers):
        for key, sub, _t in _entries(layer):
            path = _path(k, key, sub)
            if path not in params:
                continue                                  # BN buffers
            for mv in ("m", "v"):
                src = d[mv][f"l{k}"][key]
                a = np.asarray(src[sub] if sub else src, np.float32)
                out[mv][path] = torch.as_tensor(a).to(params[path].device)
    return out


def opt_state_to_numpy(layers, opt_state: Dict) -> Dict:
    """The port's Adam state in the reference's nested form."""
    out: Dict = {"m": {}, "v": {}, "step": np.int32(int(opt_state["step"]))}
    for k, layer in enumerate(layers):
        for mv in ("m", "v"):
            dd = out[mv].setdefault(f"l{k}", {})
            for key, sub, t in _entries(layer):
                src = opt_state[mv].get(_path(k, key, sub))
                a = (np.zeros(tuple(t.shape), np.float32) if src is None
                     else src.detach().cpu().numpy().copy())
                if sub:
                    dd.setdefault(key, {})[sub] = a
                else:
                    dd[key] = a
    return out
