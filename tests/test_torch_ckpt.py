"""Checkpoints of the port (``ckpt/store.py``): round trip, retention, key
and shape checks, atomic writes, the manifest, a crash and resume at a step
that is not the end of a chunk, and checkpoints crossing between the port and
the reference's ``repro.ckpt.store`` in both directions (the same ``.npz``
keys, equal arrays)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.store import CheckpointStore as RefStore
from repro.core.lut_layers import LUTDense as RefLUTDense
from repro.optim import adam as ref_adam
from repro.train.steps import TrainHParams as RefHParams
from repro.train.steps import make_lut_train_step as ref_make_step
from repro_torch import interop
from repro_torch.ckpt.store import CheckpointStore
from repro_torch.core.lut_layers import LUTDense
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.loop import run_chunked
from repro_torch.train.steps import TrainHParams, make_lut_train_step, named_params

torch.set_num_threads(2)

DIMS, HIDDEN, BATCH = (6, 5, 3), 3, 16
LR = 1e-3


def _layers(seed=0, hidden=HIDDEN):
    return [LUTDense(ci, co, hidden=hidden, use_batchnorm=(k == 0), device="cpu",
                     generator=torch.Generator().manual_seed(seed + k))
            for k, (ci, co) in enumerate(zip(DIMS[:-1], DIMS[1:]))]


def _get_batch(step: int) -> dict:
    rng = np.random.default_rng([31, step])
    return {"x": rng.normal(0, 1, (BATCH, DIMS[0])).astype(np.float32),
            "y": rng.integers(0, DIMS[-1], BATCH).astype(np.int32)}


def _trained(seed=0, steps=2):
    """A port stack after ``steps`` train steps, and its Adam state."""
    layers = _layers(seed)
    step_fn, init_fn = make_lut_train_step(layers, TrainHParams(adam=AdamConfig(lr=LR)))
    opt = init_fn()
    for s in range(steps):
        opt, _ = step_fn(opt, {k: torch.from_numpy(v) for k, v in _get_batch(s).items()})
    return layers, opt


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: np.asarray(tree)}


def _state(layers, opt):
    return _flat({"params": interop.stack_params_to_numpy(layers),
                  "opt": interop.opt_state_to_numpy(layers, opt)})


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_round_trip_restores_every_array_and_the_manifest(tmp_path):
    layers, opt = _trained()
    store = CheckpointStore(str(tmp_path))
    store.save(2, layers, opt, extra={"seed": 0, "cursor": 32}, blocking=True)
    fresh = _layers(seed=9)
    _, init_fn = make_lut_train_step(fresh, TrainHParams())
    got_layers, got_opt, manifest = store.restore(fresh, init_fn())
    assert got_layers == fresh
    assert manifest == {"step": 2, "seed": 0, "cursor": 32}
    _assert_same(_state(fresh, got_opt), _state(layers, opt))
    assert got_opt["step"].dtype == torch.int32 and int(got_opt["step"]) == 2
    assert "l0/bn_mean" not in got_opt["m"]             # buffers have no moments
    _, opt_none, _ = store.restore(_layers(seed=9))       # params only
    assert opt_none is None


def test_checkpoint_keys_are_the_reference_layout(tmp_path):
    layers, opt = _trained()
    CheckpointStore(str(tmp_path)).save(2, layers, opt, blocking=True)
    with np.load(os.path.join(tmp_path, "step_0000000002.npz")) as z:
        keys = set(z.files)
    assert {"params/l0/w0", "params/l0/q_in/f", "params/l0/bn_mean", "params/l1/q_out/i",
            "opt/m/l0/w0", "opt/v/l1/b_out", "opt/m/l0/bn_var", "opt/step"} <= keys
    n_leaves = sum(1 for layer in layers
                   for _ in list(layer.named_parameters()) + list(layer.named_buffers()))
    assert len(keys) == 3 * n_leaves + 1


def test_retention_keeps_the_last_n(tmp_path):
    layers, opt = _trained(steps=1)
    store = CheckpointStore(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        store.save(step, layers, opt)
    store.wait()
    assert store.list_steps() == [3, 4] and store.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:010d}{e}" for s in (3, 4)
                                            for e in (".json", ".npz")]


def test_shape_and_key_mismatch_rejected_before_loading(tmp_path):
    layers, opt = _trained()
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.restore(layers)
    store.save(2, layers, opt, blocking=True)
    wide = _layers(seed=5, hidden=HIDDEN + 1)
    before = interop.stack_params_to_numpy(wide)
    with pytest.raises(ValueError, match="shape"):
        store.restore(wide)
    after = interop.stack_params_to_numpy(wide)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(after),
                                                    jax.tree_util.tree_leaves(before)))
    store.save(3, layers, None, blocking=True)            # no Adam state in it
    with pytest.raises(KeyError, match="opt/"):
        store.restore(_layers(), opt, step=3)


def test_no_tmp_left_behind_and_manifest_fields(tmp_path):
    layers, opt = _trained(steps=1)
    store = CheckpointStore(str(tmp_path))
    store.save(7, layers, opt, extra={"mesh": [1]})
    store.save(8, layers, opt, extra={"mesh": [1]})
    store.wait()
    names = os.listdir(tmp_path)
    assert not [n for n in names if n.endswith(".tmp")]
    with open(os.path.join(tmp_path, "step_0000000008.json")) as f:
        assert json.load(f) == {"step": 8, "mesh": [1]}


def test_crash_and_resume_at_an_unaligned_step_is_bit_identical(tmp_path):
    """Save at step 5 (chunks of 4, so a boundary cuts a chunk), crash at
    step 7, restore into fresh layers and Adam state and run 5 -> 14: every
    bit equal to the straight run."""
    hp = TrainHParams(adam=AdamConfig(lr=LR))

    def run(layers, opt, start, stop, on_chunk=None):
        step_fn, init_fn = make_lut_train_step(layers, hp)
        return run_chunked(step_fn, named_params(layers), init_fn() if opt is None else opt,
                           _get_batch, start, stop, chunk_steps=4, boundaries=[5],
                           on_chunk=on_chunk)[1]

    straight = _layers()
    want = _state(straight, run(straight, None, 0, 14))
    store = CheckpointStore(str(tmp_path))
    crashed = _layers()

    def save(r):
        if r.step + r.k == 5:
            store.save(5, crashed, r.opt_state, blocking=True)

    run(crashed, None, 0, 7, on_chunk=save)
    assert store.list_steps() == [5]
    resumed = _layers(seed=3)
    _, init_fn = make_lut_train_step(resumed, hp)
    _, opt, manifest = store.restore(resumed, init_fn())
    assert manifest["step"] == 5 and int(opt["step"]) == 5
    _assert_same(_state(resumed, run(resumed, opt, 5, 14)), want)


# ------------------------------------------------------ across the packages
def _ref_trained(steps=2):
    """The reference's stack of the same shapes after ``steps`` einsum steps."""
    ref_layers = [RefLUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0))
                  for k, (ci, co) in enumerate(zip(DIMS[:-1], DIMS[1:]))]
    step_fn, init_fn = ref_make_step(ref_layers, RefHParams(adam=ref_adam.AdamConfig(lr=LR)),
                                     donate=False)
    params, opt = init_fn(jax.random.PRNGKey(4))
    for s in range(steps):
        params, opt, _ = step_fn(params, opt, {k: jnp.asarray(v)
                                               for k, v in _get_batch(s).items()})
    return params, opt


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, opt = _ref_trained()
    RefStore(str(tmp_path / "ref")).save(2, params, opt, extra={"seed": 4}, blocking=True)
    layers = _layers(seed=8)
    _, init_fn = make_lut_train_step(layers, TrainHParams())
    _, port_opt, manifest = CheckpointStore(str(tmp_path / "ref")).restore(layers, init_fn())
    assert manifest == {"step": 2, "seed": 4}
    want = _flat({"params": jax.tree_util.tree_map(np.asarray, params),
                  "opt": jax.tree_util.tree_map(np.asarray, opt)})
    _assert_same(_state(layers, port_opt), want)
    # the port writes the same keys for the same stack
    CheckpointStore(str(tmp_path / "port")).save(2, layers, port_opt, blocking=True)
    with np.load(tmp_path / "ref" / "step_0000000002.npz") as a, \
            np.load(tmp_path / "port" / "step_0000000002.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    layers, opt = _trained()
    CheckpointStore(str(tmp_path)).save(2, layers, opt, extra={"seed": 0}, blocking=True)
    ref_params, ref_opt = _ref_trained(steps=0)
    got_params, got_opt, manifest = RefStore(str(tmp_path)).restore(ref_params, ref_opt)
    assert manifest == {"step": 2, "seed": 0}
    got = _flat({"params": jax.tree_util.tree_map(np.asarray, got_params),
                 "opt": jax.tree_util.tree_map(np.asarray, got_opt)})
    _assert_same(got, _state(layers, opt))
