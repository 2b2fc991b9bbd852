"""Carrying parameters between the reference and the port as numpy.

The reference's ``LUTDense.init`` / trained parameter dict — ``w0``, ``b0``,
``w_out`` (C_in, C_out, H), ``b_out``, nested ``q_in`` / ``q_out`` with
``f`` and ``i``, and the BN ``bn_scale`` / ``bn_bias`` / ``bn_mean`` /
``bn_var`` — crosses as a dict of numpy arrays with the same keys and
shapes.  Seeds cannot carry weights across, because ``jax.random`` and
torch's generators differ.  DAIS programs cross as
``DaisProgram.to_arrays()`` / ``from_arrays()`` (wire format v2), which the
port reads unchanged.

An ``HGQDense`` crosses with the keys ``w``, ``b``, ``q_w`` and ``q_a``, an
``NLALayer`` with ``map_logits`` and the nested ``leaf`` / ``root`` MLP
dicts.  A
conv wrapper (``LUTConv1D/2D``, ``HGQConv1D``) crosses as its ``dense``
layer's dict, as the reference's conv parameters are its dense's.  The PID
hybrid crosses as the reference example's ``{"front", "lc1", "lc2",
"head"}`` dict.

A stack crosses as ``{"l0": layer dict, "l1": ...}``.  A model of the LM
zoo (``DecoderLM``, ``ZambaHybrid``, ``RWKV6LM``, ``WhisperEncDec``: any
module with ``flat_params``) crosses as the reference's nested dict
(``{"embed", "blocks": {"wq", ...}, "final_norm", "head"}``, ``shared``,
``enc_blocks``...) and its Adam state as ``{"m": that tree, "v": that
tree, "step"}`` (``lm_params_*``, ``lm_opt_state_*``).  The Adam state
crosses as the reference's ``{"m": stack dict, "v": stack dict, "step"}``;
the reference keeps moments for the BN ``bn_mean`` / ``bn_var`` too, which
are buffers in the port and always zero in the reference (their gradient is
zero), so they are dropped on the way in and written as zeros on the way out.

``checkpoint_tree`` / ``load_checkpoint_tree`` take either (a stack or a
zoo model) and are the one place that tells them apart, for
``ckpt/store.py``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.hgq_layers import HGQDense
from repro_torch.core.lut_layers import LUTDense
from repro_torch.core.nla_baseline import NLALayer
from repro_torch.models.pid import PID_KEYS


def _dense_of(layer):
    """The layer that carries ``layer``'s parameters: a conv wrapper's
    ``dense``, else the layer itself."""
    return getattr(layer, "dense", layer)


def _entries(module):
    """(key, sub-key or None, tensor) for every reference parameter."""
    out = []
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        key, _, sub = name.partition(".")
        out.append((key, sub or None, t))
    return out


def _from_numpy(module, d: Dict):
    want = {(k, s) for k, s, _ in _entries(module)}
    got = {(k, s) for k, v in d.items()
           for s in (v if isinstance(v, dict) else [None])}
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


def _to_numpy(module) -> Dict:
    d: Dict = {}
    for key, sub, t in _entries(module):
        a = t.detach().cpu().numpy().copy()
        if sub:
            d.setdefault(key, {})[sub] = a
        else:
            d[key] = a
    return d


def _check_type(module, cls):
    if not isinstance(module, cls):
        raise TypeError(f"expected a {cls.__name__}, got {type(module).__name__}")


def lut_dense_params_from_numpy(module: LUTDense, d: Dict) -> LUTDense:
    """Load a reference ``LUTDense`` parameter dict (numpy leaves) into
    ``module``.  Keys and shapes must match exactly; returns the module."""
    _check_type(module, LUTDense)
    return _from_numpy(module, d)


def lut_dense_params_to_numpy(module: LUTDense) -> Dict:
    """The module's parameters as a reference-shaped dict of numpy arrays."""
    _check_type(module, LUTDense)
    return _to_numpy(module)


def hgq_dense_params_from_numpy(module: HGQDense, d: Dict) -> HGQDense:
    """Load a reference ``HGQDense`` parameter dict (``w``, ``b``, ``q_w``,
    ``q_a``) into ``module``; keys and shapes must match exactly."""
    _check_type(module, HGQDense)
    return _from_numpy(module, d)


def hgq_dense_params_to_numpy(module: HGQDense) -> Dict:
    _check_type(module, HGQDense)
    return _to_numpy(module)


def nla_params_from_numpy(module: NLALayer, d: Dict) -> NLALayer:
    """Load a reference ``NLALayer`` parameter dict (``map_logits``, and
    ``leaf`` / ``root`` each with ``w0, b0, ..., w_out, b_out``) into
    ``module``; keys and shapes must match exactly."""
    _check_type(module, NLALayer)
    return _from_numpy(module, d)


def nla_params_to_numpy(module: NLALayer) -> Dict:
    _check_type(module, NLALayer)
    return _to_numpy(module)


def layer_params_from_numpy(layer, d: Dict):
    """Load a reference layer dict into ``layer`` (a dense layer or a conv
    wrapper, through its ``dense``); returns the layer."""
    dense = _dense_of(layer)
    if isinstance(dense, HGQDense):
        hgq_dense_params_from_numpy(dense, d)
    else:
        lut_dense_params_from_numpy(dense, d)
    return layer


def layer_params_to_numpy(layer) -> Dict:
    dense = _dense_of(layer)
    if isinstance(dense, HGQDense):
        return hgq_dense_params_to_numpy(dense)
    return lut_dense_params_to_numpy(dense)


def pid_params_from_numpy(layers, d: Dict):
    """Load the reference example's ``{"front", "lc1", "lc2", "head"}``
    dict (``jax.tree.map(np.asarray, params)``) into the PID hybrid's
    ``(front, lc1, lc2, head)``; returns the layers."""
    if set(d) != set(PID_KEYS) or len(layers) != len(PID_KEYS):
        raise KeyError(f"pid keys {sorted(d)} do not match {PID_KEYS}")
    for key, layer in zip(PID_KEYS, layers):
        layer_params_from_numpy(layer, d[key])
    return layers


def pid_params_to_numpy(layers) -> Dict:
    return {key: layer_params_to_numpy(layer) for key, layer in zip(PID_KEYS, layers)}


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


# ----------------------------------------------------------------- the LM zoo
def nest(flat: Dict) -> Dict:
    """``{"blocks/wq": a}`` -> ``{"blocks": {"wq": a}}``."""
    out: Dict = {}
    for path, a in flat.items():
        *heads, last = path.split("/")
        d = out
        for h in heads:
            d = d.setdefault(h, {})
        d[last] = a
    return out


def unnest(tree: Dict, prefix: str = "") -> Dict:
    """The inverse of :func:`nest`: leaves by ``/``-joined path."""
    out: Dict = {}
    for key, sub in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out.update(unnest(sub, path) if isinstance(sub, dict) else {path: sub})
    return out


def _check_lm_keys(model, flat: Dict, what: str) -> None:
    want, got = set(model.flat_params()), set(flat)
    if want != got:
        raise KeyError(f"{what} keys differ: missing {sorted(want - got)}, "
                       f"unexpected {sorted(got - want)}")


def is_zoo_model(params) -> bool:
    """True for a model of the LM zoo (it has ``flat_params``), False for a
    stack of layers."""
    return hasattr(params, "flat_params")


def lm_params_from_numpy(model, tree: Dict):
    """Load the reference's nested parameter dict of a zoo model
    (``{"embed", "blocks": {...}, "final_norm", "head"}`` for a decoder,
    numpy leaves) into ``model``; keys and shapes must match exactly.
    Returns the model."""
    flat = unnest(tree)
    _check_lm_keys(model, flat, "parameter")
    with torch.no_grad():
        for path, p in model.flat_params().items():
            a = np.asarray(flat[path])
            if a.shape != tuple(p.shape):
                raise ValueError(f"{path}: shape {a.shape} != {tuple(p.shape)}")
            p.copy_(torch.as_tensor(a, dtype=p.dtype))
    return model


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def lm_params_to_numpy(model) -> Dict:
    """The model's parameters as the reference's nested dict of numpy arrays
    (a model on a mesh gives its whole arrays)."""
    return nest({k: _whole(p.detach()).cpu().numpy().copy()
                 for k, p in model.flat_params().items()})


def lm_opt_state_from_numpy(model, tree: Dict) -> Dict:
    """The reference's Adam state ``{"m": tree, "v": tree, "step"}`` as the
    port's (flat by path, on the model's parameters' devices)."""
    params = model.flat_params()
    out: Dict = {"step": torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                                      device=model.device)}
    for mv in ("m", "v"):
        flat = unnest(tree[mv])
        _check_lm_keys(model, flat, f"Adam {mv}")
        out[mv] = {k: torch.as_tensor(np.asarray(flat[k], np.float32)).to(p.device)
                   for k, p in params.items()}
    return out


def lm_opt_state_to_numpy(model, opt_state: Dict) -> Dict:
    """The port's Adam state of ``model`` in the reference's nested form."""
    out: Dict = {"step": np.int32(int(_whole(opt_state["step"])))}
    for mv in ("m", "v"):
        out[mv] = nest({k: _whole(opt_state[mv][k].detach()).cpu().numpy().copy()
                        for k in model.flat_params()})
    return out


# ------------------------------------------------------------ for checkpoints
def checkpoint_tree(params, opt_state=None) -> Dict:
    """``{"params": tree, "opt": tree}`` (``opt`` only with ``opt_state``) of
    a stack of layers or a zoo model, in the reference's nesting."""
    lm = is_zoo_model(params)
    tree = {"params": lm_params_to_numpy(params) if lm else stack_params_to_numpy(params)}
    if opt_state is not None:
        tree["opt"] = (lm_opt_state_to_numpy(params, opt_state) if lm
                       else opt_state_to_numpy(params, opt_state))
    return tree


def load_checkpoint_tree(params, tree: Dict):
    """Load ``tree["params"]`` into ``params`` (a stack or a zoo model) in
    place; returns the Adam state of ``tree["opt"]``, or None without it."""
    lm = is_zoo_model(params)
    (lm_params_from_numpy if lm else stack_params_from_numpy)(params, tree["params"])
    if "opt" not in tree:
        return None
    return (lm_opt_state_from_numpy if lm else opt_state_from_numpy)(params, tree["opt"])
