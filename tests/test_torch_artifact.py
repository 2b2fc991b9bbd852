"""Compiled-artifact bundles held against the reference, on the CPU.

* The same program saved by either package (``attestation=None``) gives the
  same content hash and the same arrays, for the JSC-HLF stack (lowered by
  the port), a small pid-hybrid context and a conv hybrid (lowered by the
  reference); programs cross as ``DaisProgram.to_arrays()``.
* A reference bundle loads in the port and a port bundle in the reference,
  each with the content hash it was saved with, and each serves bit for bit
  against ``DaisProgram.run``.
* A v1 bundle is negotiated; tampered, forged, rehashed-invalid, unreadable
  and newer-versioned bundles are refused by both packages with the same
  message.
* A stored int64-packed payload on an int32 engine equals a chain packed at
  int32, through the plain chain and through the model of kernel B4 at every
  bucket of the scheduler's ladder.
* ``build`` on bundles: ``verify="cached"``, the gate's fallback, provenance,
  ``optimize=True`` refused, the deprecated ``build_engine`` shim.
"""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro.serve import api as ref_api
from repro.serve import artifact as ref_art
from repro_torch.core.dais import _OP_CODES, DaisProgram
from repro_torch.core.lower import compile_sequential
from repro_torch.kernels import lut_serve_cuda as b4
from repro_torch.kernels.lut_serve import (compile_program,
                                           compose_fused_stages,
                                           input_code_bounds, verify_engine)
from repro_torch.launch.serve import build_lut_stack
from repro_torch.serve import artifact as art
from repro_torch.serve.api import EngineSpec, build
from repro_torch.serve.scheduler import bucket_ladder

torch.set_num_threads(2)

MODELS = ("jsc", "pid", "conv")


def _jsc():
    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return compile_sequential(layers, 4, 2)


def _ref_pid():
    from repro.core.lower import lower
    from repro.models.pid import (build_pid_graph, build_pid_layers,
                                  init_pid_params)

    layers = build_pid_layers(hidden=4)
    params = init_pid_params(layers, jax.random.PRNGKey(5))
    return lower(build_pid_graph(layers, n_samples=40), [*params, None])


def _ref_conv():
    """The reference's conv hybrid of ``tests/test_serve_artifact.py``."""
    from repro.core.hgq_layers import HGQConv1D
    from repro.core.lower import GraphInput, ModelGraph, WindowSum, lower
    from repro.core.lut_layers import LUTConv1D, LUTDense

    front = HGQConv1D(c_in=1, c_out=3, kernel=4, stride=4, activation="relu")
    lc = LUTConv1D(c_in=3, c_out=3, kernel=3, padding="SAME", hidden=4)
    head = LUTDense(3, 1, hidden=4)
    ks = jax.random.split(jax.random.PRNGKey(23), 3)
    params = [front.init(ks[0]), lc.init(ks[1]), head.init(ks[2])]
    graph = ModelGraph(GraphInput((16, 1), 4, 2), [front, lc, head, WindowSum()])
    return lower(graph, params + [None])


@pytest.fixture(scope="module")
def progs():
    """name -> (port program, reference program): the same arrays."""
    jsc = _jsc()
    out = {"jsc": (jsc, RefDaisProgram.from_arrays(jsc.to_arrays()))}
    for name, ref in (("pid", _ref_pid()), ("conv", _ref_conv())):
        out[name] = (DaisProgram.from_arrays(ref.to_arrays()), ref)
    return out


@pytest.fixture(scope="module")
def bundles(progs, tmp_path_factory):
    """name -> (port bundle path, reference bundle path, port digest,
    reference digest), both saved with no attestation."""
    d = tmp_path_factory.mktemp("bundles")
    out = {}
    for name, (prog, ref) in progs.items():
        p, r = str(d / f"{name}-port.npz"), str(d / f"{name}-ref.npz")
        out[name] = (p, r, art.save_artifact(p, prog),
                     ref_art.save_artifact(r, ref))
    return out


def _codes(prog, n, seed):
    lo, hi = input_code_bounds(prog)
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, len(lo)))


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------- #
# the wire format: same bytes, same hash
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", MODELS)
def test_same_program_same_digest_in_both_packages(bundles, name):
    p, r, hp, hr = bundles[name]
    assert hp == hr
    a, b = _arrays(p), _arrays(r)
    assert a.keys() == b.keys()
    assert any(k.startswith("packed/") for k in a)           # v3 payload
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert art.content_hash(a) == ref_art.content_hash(b)


@pytest.mark.parametrize("name", MODELS)
def test_reference_bundle_serves_in_the_port(progs, bundles, name):
    prog, ref = progs[name]
    _p, r, _hp, hr = bundles[name]
    loaded = art.load_artifact(r)
    assert loaded.content_hash == hr == loaded.meta["content_hash"]
    assert loaded.meta["format_version"] == 3 and loaded.packed is not None
    codes = _codes(prog, 512, seed=1)
    want = ref.run(codes)
    for engine in ("pallas", "fused"):
        built = build(r, EngineSpec(engine=engine, require=engine, verify="full",
                                    n_random=256), device="cpu")
        assert built.engine.path == engine and built.content_hash == hr
        assert built.source == r and built.attestation["random"] == 256
        got = built.engine.run(codes).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_port_bundle_serves_in_the_reference(progs, bundles, tmp_path, name):
    prog, ref = progs[name]
    gate = build(prog, EngineSpec(engine="pallas", verify="full", n_random=128),
                 device="cpu").attestation
    path = str(tmp_path / "attested.npz")
    digest = art.save_artifact(path, prog, attestation=gate)
    loaded = ref_art.load_artifact(path)
    assert loaded.content_hash == digest and loaded.attestation == gate
    built = ref_api.build(path, ref_api.EngineSpec(verify="cached"))
    assert built.content_hash == digest and "gate_s" not in built.timings
    codes = _codes(prog, 256, seed=2)
    np.testing.assert_array_equal(
        np.asarray(built.engine.run(codes), np.int64), ref.run(codes))
    # and the attested bundle reads back in the port with the same hash
    assert art.load_artifact(path).content_hash == digest


def test_v1_bundle_negotiated(progs, tmp_path):
    """A v1 bundle, written as ``tests/test_serve_artifact.py`` writes one:
    its legacy fused payload is ignored and stages are recomposed."""
    prog, ref = progs["jsc"]
    arrays = {f"prog/{k}": v for k, v in prog.to_arrays().items()}
    arrays["prog/version"] = np.asarray([1], np.int64)
    arrays["prog/seg_meta"] = arrays["prog/seg_meta"][:, :4]
    arrays["fused/n_stages"] = np.asarray([1], np.int64)
    arrays["fused/table0"] = np.zeros((2, 2, 2), np.int64)
    meta_core = {"format_version": 1, "fused": True, "attestation": None}
    digest = art._bundle_digest(arrays, meta_core)
    assert digest == ref_art._bundle_digest(arrays, meta_core)
    meta = {**meta_core, "content_hash": digest}
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **arrays)
    loaded = art.load_artifact(path)
    assert loaded.meta["format_version"] == 1 and loaded.stages is None
    assert loaded.packed is None and loaded.content_hash == digest
    built = build(loaded, EngineSpec(engine="pallas", require="pallas",
                                     n_random=256), device="cpu")
    assert built.attestation["random"] == 256        # no stored attestation
    codes = _codes(prog, 256, seed=3)
    np.testing.assert_array_equal(built.engine.run(codes).numpy(), ref.run(codes))


# --------------------------------------------------------------------------- #
# tampering: both packages refuse, with the reference's message
# --------------------------------------------------------------------------- #
def _rewrite(path, mutate, rehash=False):
    arrays = {k: v.copy() for k, v in _arrays(path).items()}
    meta = json.loads(bytes(arrays.pop("meta_json")).decode())
    mutate(arrays, meta)
    if rehash:          # as an adversary with write access would
        meta_core = {k: v for k, v in meta.items() if k != "content_hash"}
        meta["content_hash"] = art._bundle_digest(arrays, meta_core)
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    np.savez(path, **arrays)


def _first(arrays, prefix, suffix):
    return next(k for k in sorted(arrays) if k.startswith(prefix) and k.endswith(suffix))


def _flip_prog_table(arrays, meta):
    arrays[_first(arrays, "prog/table", "codes")][0, 0, 0] += 1


def _flip_fused_table(arrays, meta):
    arrays["fused/stage0_table"][0, 0, 0] ^= 1


def _flip_packed_table(arrays, meta):
    arrays[_first(arrays, "packed/stage", "_table")].flat[0] ^= 1


def _flip_gather(arrays, meta):
    arrays[_first(arrays, "fused/stage", "_gather")].flat[0] += 1


def _flip_bias(arrays, meta):
    arrays[_first(arrays, "fused/stage", "_bias")].flat[0] += 1


def _forge_attestation(arrays, meta):
    meta["attestation"] = {"random": 10 ** 9, "exhaustive": 0}


def _bump_version(arrays, meta):
    meta["format_version"] = 99


def _dangling_register(arrays, meta):
    idx = int(np.flatnonzero(arrays["prog/instr_op"] == _OP_CODES.index("REQUANT"))[0])
    arrays["prog/instr_args"][idx, 0] = 10 ** 6


def _oversized_llut(arrays, meta):
    key = _first(arrays, "prog/table", "_in_width")
    arrays[key] = arrays[key] + 7


TAMPER = [
    ("jsc", _flip_prog_table, False, "hash mismatch"),
    ("jsc", _flip_fused_table, False, "hash mismatch"),
    ("jsc", _flip_packed_table, False, "hash mismatch"),
    ("conv", _flip_gather, False, "hash mismatch"),
    ("conv", _flip_bias, False, "hash mismatch"),
    ("jsc", _forge_attestation, False, "hash mismatch"),
    ("jsc", _bump_version, False, "format_version"),
    ("jsc", _dangling_register, True, "structural verifier"),
    ("jsc", _oversized_llut, True, "structural verifier"),
]


@pytest.mark.parametrize("name,mutate,rehash,match", TAMPER,
                         ids=[t[1].__name__.strip("_") for t in TAMPER])
def test_tampered_bundles_refused_by_both(progs, tmp_path, name, mutate, rehash, match):
    prog, _ref = progs[name]
    path = str(tmp_path / "model.npz")
    art.save_artifact(path, prog, attestation={"random": 16, "exhaustive": 0})
    _rewrite(path, mutate, rehash)
    with pytest.raises(art.ArtifactError, match=match) as mine:
        art.load_artifact(path)
    with pytest.raises(ref_art.ArtifactError, match=match) as theirs:
        ref_art.load_artifact(path)
    assert str(mine.value).split("\n")[0] == str(theirs.value).split("\n")[0]
    with pytest.raises(art.ArtifactError, match=match):
        build(path, EngineSpec(verify="skip"), device="cpu")


def test_unreadable_and_empty_bundles_refused(tmp_path):
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not an npz at all")
    with pytest.raises(art.ArtifactError, match="cannot read"):
        art.load_artifact(str(garbage))
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, x=np.zeros(3))
    with pytest.raises(art.ArtifactError, match="no meta_json"):
        art.load_artifact(bare)


# --------------------------------------------------------------------------- #
# the stored packed payload on the int32 engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["jsc", "pid"])
def test_int64_packed_payload_on_an_int32_engine(progs, bundles, name):
    """The bundle's payload is packed with int64 arithmetic; lowered at the
    int32 engine's dtype it serves exactly what a chain packed at int32
    serves, through the plain chain and through the PyTorch model of kernel
    B4 (``tests/test_torch_b4_design.py``) at every bucket 1..64."""
    from test_torch_b4_design import H100_SMS, _model

    prog, ref = progs[name]
    loaded = art.load_artifact(bundles[name][0])
    stored = loaded.packed
    assert all(st.bias.dtype == np.int64 for st in stored.stages)
    fresh = compile_program(prog, device="cpu", engine="pallas")
    from_bundle = build(loaded, EngineSpec(engine="pallas", require="pallas",
                                           verify="skip"), device="cpu").engine
    assert fresh.dtype == from_bundle.dtype == torch.int32
    stages, why = compose_fused_stages(prog)
    assert stages is not None, why
    chain32 = b4.PackedChain(b4.pack_stages(stages, torch.int32), torch.int32, "cpu")
    low = b4.lower_chain(stored, torch.int32)
    blocks = H100_SMS * b4.blocks_per_sm(low.plan, 4)
    for bucket in bucket_ladder(64):
        codes = _codes(prog, bucket, seed=bucket)
        x = torch.as_tensor(codes, dtype=torch.int32)
        want = b4.run_chain_plain(chain32, x)
        np.testing.assert_array_equal(want.numpy(), ref.run(codes))
        assert torch.equal(from_bundle.run(codes), want)
        assert torch.equal(fresh.run(codes), want)
        assert torch.equal(_model(low, torch.int32, x, blocks), want)


# --------------------------------------------------------------------------- #
# build() on bundle sources
# --------------------------------------------------------------------------- #
def test_build_cached_full_and_skip(progs, tmp_path):
    prog, _ref = progs["jsc"]
    path = str(tmp_path / "m.npz")
    fresh = build(prog, EngineSpec(engine="pallas", n_random=64), device="cpu")
    assert fresh.content_hash is None and fresh.source is None
    digest = art.save_artifact(path, prog, attestation=fresh.attestation)
    assert not os.path.exists(path + ".tmp")                  # atomic rename

    cached = build(path, EngineSpec(engine="pallas", verify="cached"), device="cpu")
    assert cached.attestation == fresh.attestation and "gate_s" not in cached.timings
    assert {"load_s", "compile_s"} <= cached.timings.keys()
    assert cached.content_hash == digest and cached.source == path
    full = build(path, EngineSpec(engine="pallas", verify="full", n_random=32),
                 device="cpu")
    assert full.attestation["random"] == 32 and "gate_s" in full.timings
    skipped = build(art.load_artifact(path), EngineSpec(verify="skip"), device="cpu")
    assert skipped.source is None and skipped.attestation == fresh.attestation

    bare = str(tmp_path / "bare.npz")
    art.save_artifact(bare, prog)                  # no attestation: cached gates
    gated = build(bare, EngineSpec(n_random=48), device="cpu")
    assert gated.attestation["random"] == 48 and "gate_s" in gated.timings
    with pytest.raises(ValueError, match="optimize=True"):
        build(bare, EngineSpec(optimize=True), device="cpu")
    with pytest.raises(TypeError, match="bundle path"):
        build(42, device="cpu")


def test_bundle_without_fused_payload_recomposes(progs, tmp_path):
    prog, ref = progs["conv"]
    path = str(tmp_path / "nofuse.npz")
    digest = art.save_artifact(path, prog, compose=False)
    assert digest == ref_art.save_artifact(str(tmp_path / "r.npz"), ref, compose=False)
    loaded = art.load_artifact(path)
    assert loaded.stages is None and loaded.packed is None
    built = build(loaded, EngineSpec(engine="pallas", require="pallas", n_random=128),
                  device="cpu")
    codes = _codes(prog, 128, seed=5)
    np.testing.assert_array_equal(built.engine.run(codes).numpy(), ref.run(codes))


def test_deprecated_build_engine_shim(progs, bundles):
    prog, _ref = progs["pid"]
    loaded = art.load_artifact(bundles["pid"][0])
    with pytest.warns(DeprecationWarning, match="deprecated"):
        old = art.build_engine(loaded, device="cpu", engine="pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        new = build(loaded, EngineSpec(engine="pallas", verify="skip"), device="cpu").engine
    assert old.path == new.path == "pallas"
    codes = _codes(prog, 64, seed=6)
    assert torch.equal(old.run(codes), new.run(codes))
    verify_engine(old, prog, n_random=64)
