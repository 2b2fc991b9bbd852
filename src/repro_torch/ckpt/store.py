"""Checkpointing: async, atomic ``.npz`` bundles (port of ``repro.ckpt.store``).

* **atomic** -- write to ``<name>.tmp`` then ``os.replace``, so a crash mid-
  save never corrupts the latest checkpoint;
* **async** -- the arrays are copied to the host on the caller's thread and
  written on a worker thread, so the train loop waits only for the copy;
* **one layout for both packages** -- arrays are stored by logical path as
  the reference stores them: ``params/<layer>/<key>`` (``params/l0/q_in/f``,
  the BN stats included), ``opt/m/<path>``, ``opt/v/<path>`` and
  ``opt/step``, the keys ``jax.tree_util.tree_flatten_with_path`` makes of
  ``{"params": ..., "opt": ...}``.  The Adam state crosses through
  ``interop.opt_state_to_numpy`` / ``opt_state_from_numpy``: the reference
  keeps zero moments for ``bn_mean`` / ``bn_var``, the port none.  So each
  package restores the other's checkpoints;
* **manifest** -- the step and whatever the caller adds (data cursor, seed)
  are stored beside the arrays;
* **retention** -- keep the last N checkpoints, delete older ones.

The port's parameters live in modules, so ``save`` and ``restore`` take
the modules (a stack of layers, or a model of the LM zoo) where the reference
takes its parameter tree, and ``restore`` loads into them in place.  They
cross to and from the reference's tree through
``interop.checkpoint_tree`` / ``load_checkpoint_tree``, so an LM's arrays
are the reference's flat keys too (``params/blocks/wq``,
``opt/m/blocks/wq``, ``opt/step``).  A model on a mesh saves its whole
arrays, and ``restore(shardings=)`` (placements by path, as
``train.steps.param_shardings`` gives them) re-places the restored
parameters and Adam state on the model's mesh, whatever mesh saved them.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import interop


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Leaves of a nested dict by ``/``-joined path, keys in sorted order."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for key in sorted(tree):
        out.update(_flatten(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def _unflatten_like(ref_tree, arrays: Dict[str, np.ndarray], prefix: str = ""):
    """``ref_tree``'s nesting filled from ``arrays``; keys and shapes checked."""
    if isinstance(ref_tree, dict):
        return {key: _unflatten_like(sub, arrays, f"{prefix}/{key}" if prefix else str(key))
                for key, sub in ref_tree.items()}
    if prefix not in arrays:
        raise KeyError(f"checkpoint missing tensor {prefix!r}")
    arr = arrays[prefix]
    if tuple(arr.shape) != tuple(np.shape(ref_tree)):
        raise ValueError(f"{prefix}: ckpt shape {arr.shape} != expected {np.shape(ref_tree)}")
    return arr


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, params, opt_state=None,
             extra: Optional[dict] = None, blocking: bool = False) -> None:
        """Save ``params`` (a stack of layers or a zoo model) and its Adam
        state at ``step``."""
        arrays = _flatten(interop.checkpoint_tree(params, opt_state))
        manifest = {"step": int(step), **(extra or {})}
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(int(step), arrays, manifest), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, arrays, manifest) -> None:
        name = f"step_{step:010d}"
        tmp_npz = os.path.join(self.dir, name + ".npz.tmp")
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp_npz, os.path.join(self.dir, name + ".npz"))
        tmp_js = os.path.join(self.dir, name + ".json.tmp")
        with open(tmp_js, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_js, os.path.join(self.dir, name + ".json"))
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s:010d}{ext}"))
                except OSError:
                    pass

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # ------------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for fn in os.listdir(self.dir):
            if fn.startswith("step_") and fn.endswith(".npz"):
                out.append(int(fn[5:-4]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, ref_params, ref_opt=None,
                step: Optional[int] = None, device=None, shardings=None):
        """Load a checkpoint into ``ref_params`` (a stack of layers or a
        zoo model); returns ``(layers or model, opt_state, manifest)``.

        Every key and shape is checked against the modules (and against
        ``ref_opt``, their Adam state, when given) before any is loaded.
        With ``device`` the modules move there first; the Adam state is made
        on their device.  ``opt_state`` is None without ``ref_opt``, as in
        the reference.  With ``shardings`` (a zoo model built on a mesh;
        placements by path) the parameters and the Adam state come back as
        DTensors under them (the step replicated), for an elastic resume.
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        name = f"step_{step:010d}"
        with np.load(os.path.join(self.dir, name + ".npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(self.dir, name + ".json")) as f:
            manifest = json.load(f)
        one = isinstance(ref_params, torch.nn.Module)
        params = ref_params if one else list(ref_params)
        if shardings is not None:
            if not one or getattr(params, "mesh", None) is None:
                raise ValueError("shardings= re-places a zoo model built on a mesh")
            _unplace(params)
        if device is not None:
            for m in [params] if one else params:
                m.to(device)
        tree = _unflatten_like(interop.checkpoint_tree(params, ref_opt), arrays)
        opt = interop.load_checkpoint_tree(params, tree)
        if shardings is not None:
            opt = _place(params, opt, shardings)
        return params, opt, manifest


def _unplace(model) -> None:
    """Make each DTensor parameter of ``model`` a plain one of its whole value."""
    for path, p in model.flat_params().items():
        if hasattr(p, "full_tensor"):
            model.register_parameter(path, torch.nn.Parameter(
                p.detach().full_tensor(), requires_grad=p.requires_grad))


def _place(model, opt, shardings):
    """``model``'s parameters and the Adam state ``opt`` as DTensors under
    ``shardings`` on the model's mesh; returns the placed Adam state."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import place_params

    place_params(model, shardings)
    if opt is None:
        return None
    mesh = model.mesh
    out = {mv: {k: shd.distribute(v, mesh, shardings[k]) for k, v in opt[mv].items()}
           for mv in ("m", "v")}
    out["step"] = shd.distribute(opt["step"], mesh, shd.placements((), mesh))
    return out
