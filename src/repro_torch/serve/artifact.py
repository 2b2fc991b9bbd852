"""Persistent compiled-artifact bundles, port of ``repro.serve.artifact``.

A bundle captures everything after the expensive steps of a serving build
in one atomic ``.npz`` — the wire format is the reference's, byte for byte
in every array, so a bundle written by either package loads in the other
with the same content hash:

* ``prog/*``  — the serialized :class:`~repro_torch.core.dais.DaisProgram`
  (``DaisProgram.to_arrays``: instructions, register formats, per-site
  segments, truth tables stored once per layer),
* ``fused/*`` — the composed per-layer stages
  (:class:`~repro_torch.kernels.lut_serve.FusedStages`), when the program
  fuses,
* ``packed/*`` (v3) — what ``pack_stages`` derives for kernel B4's chain:
  out-shift-folded lane-dtype tables, in-shift elision flags and sum-stage
  coefficients, packed with int64 arithmetic (the gathers, biases and
  epilogues are rebuilt from the ``fused/*`` stage IR they equal),
* ``meta_json`` — format version, the **content hash**, and the
  ``verify_engine`` **attestation**.

Format versions (negotiated by :func:`load_artifact`): **v3** (current);
**v2** (read-only, no packed payload: an ``engine="pallas"`` cold start
re-packs from the fused stages); **v1** (read-only, flat sequential
programs: the legacy ``fused/*`` layout is ignored and the engine recomposes
its stages from the program).  A bundle from a newer writer is refused with
the version it asked for.

The content hash is a SHA-256 over every data array (name, dtype, shape,
bytes) and the canonical JSON of the remaining metadata, attestation
included; :func:`load_artifact` recomputes it and refuses a bundle whose
stored hash differs, then runs the structural verifier
(``core/analysis.verify_program``) on the program.  The hash makes bundles
tamper-evident (bit-rot, truncation, edits to the stored attestation); it is
not an authentication boundary, since the digest lives in the file it
protects.  Writes are atomic: ``<path>.tmp``, then ``os.replace``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import zipfile
from typing import Dict, Optional

import numpy as np

from repro_torch.core.dais import _MODE_CODES, DaisProgram
from repro_torch.kernels.lut_serve import (EpiOp, FusedStage, FusedStages,
                                           ServeEngine, compile_program,
                                           compose_fused_stages)
from repro_torch.kernels.lut_serve_cuda import (PackedStage, PackedStages,
                                                PackError, pack_stages)

logger = logging.getLogger(__name__)

FORMAT_VERSION = 3
_SUPPORTED_VERSIONS = (1, 2, 3)
_STAGE_KINDS = ("lut", "sum")
_EPI_OPS = ("REQUANT", "CMUL")


class ArtifactError(RuntimeError):
    """Bundle is unreadable, wrong version, or fails its content hash."""


def content_hash(arrays: Dict[str, np.ndarray]) -> str:
    """Order-independent SHA-256 over named arrays (dtype+shape+bytes)."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _bundle_digest(arrays: Dict[str, np.ndarray], meta_core: dict) -> str:
    """Integrity digest: data arrays + canonical JSON of the core metadata.

    Folding the metadata in means the attestation is tamper-evident too —
    an edited ``meta_json`` with an unchanged data payload still fails the
    check.  (Evident, not proof against an adversary who rewrites the
    stored hash as well — see the module docstring.)
    """
    h = hashlib.sha256()
    h.update(content_hash(arrays).encode())
    h.update(json.dumps(meta_core, sort_keys=True).encode())
    return h.hexdigest()


def _data_arrays(prog: DaisProgram,
                 stages: Optional[FusedStages]) -> Dict[str, np.ndarray]:
    arrays = {f"prog/{k}": v for k, v in prog.to_arrays().items()}
    if stages is not None:
        arrays["fused/n_stages"] = np.asarray([stages.n_stages()], np.int64)
        arrays["fused/out_cols"] = np.asarray(stages.out_cols, np.int64)
        for k, st in enumerate(stages.stages):
            p = f"fused/stage{k}_"
            arrays[p + "kind"] = np.asarray([_STAGE_KINDS.index(st.kind),
                                             st.n_cols], np.int64)
            arrays[p + "gather"] = np.asarray(st.gather, np.int64)
            arrays[p + "bias"] = np.asarray(st.bias, np.int64)
            if st.kind == "lut":
                arrays[p + "in_shift"] = np.asarray(st.in_shift, np.int64)
                arrays[p + "mask"] = np.asarray(st.mask, np.int64)
                arrays[p + "table"] = np.asarray(st.table, np.int64)
                arrays[p + "out_shift"] = np.asarray(st.out_shift, np.int64)
            else:
                arrays[p + "shifts"] = np.asarray(st.shifts, np.int64)
                arrays[p + "signs"] = np.asarray(st.signs, np.int64)
            arrays[p + "n_epi"] = np.asarray([len(st.epilogue)], np.int64)
            for m, epi in enumerate(st.epilogue):
                arrays[p + f"epi{m}_op"] = np.asarray(
                    [_EPI_OPS.index(epi.op), _MODE_CODES.index(epi.mode)],
                    np.int64)
                arrays[p + f"epi{m}_params"] = np.asarray(epi.params, np.int64)
    return arrays


def _packed_arrays(packed: PackedStages) -> Dict[str, np.ndarray]:
    """The v3 ``packed/*`` payload: only what :func:`pack_stages` derives.

    Per "lut" stage the out-shift-folded table in its lane dtype plus the
    in-shift-elision flag; per "sum" stage the ``sign << shift``
    coefficients.  Gathers, biases, masks and epilogues are *not* repeated —
    the loader reconstructs them from the ``fused/*`` stage IR they equal.
    """
    arrays = {"packed/n_stages": np.asarray([packed.n_stages()], np.int64)}
    for k, st in enumerate(packed.stages):
        p = f"packed/stage{k}_"
        if st.kind == "lut":
            arrays[p + "table"] = np.asarray(st.table)      # lane dtype
            arrays[p + "flags"] = np.asarray(
                [st.in_shift is not None], np.int64)
        else:
            arrays[p + "coef"] = np.asarray(st.coef, np.int64)
    return arrays


def _packed_from_arrays(arrays: Dict[str, np.ndarray],
                        stages: FusedStages) -> PackedStages:
    """Rebuild :class:`PackedStages` from ``packed/*`` + the fused stage IR."""
    n = int(arrays["packed/n_stages"][0])
    if n != stages.n_stages():
        raise ArtifactError(
            f"packed payload has {n} stages but the fused IR has "
            f"{stages.n_stages()} — bundle is internally inconsistent")
    out = []
    for k, st in enumerate(stages.stages):
        p = f"packed/stage{k}_"
        common = dict(kind=st.kind, gather=np.asarray(st.gather, np.int64),
                      n_cols=st.n_cols, bias=np.asarray(st.bias, np.int64),
                      epilogue=[EpiOp(op=e.op, mode=e.mode,
                                      params=np.asarray(e.params, np.int64))
                                for e in st.epilogue])
        if st.kind == "lut":
            in_shift = np.asarray(st.in_shift, np.int64)
            out.append(PackedStage(
                **common,
                in_shift=in_shift if bool(arrays[p + "flags"][0]) else None,
                mask=np.asarray(st.mask, np.int64),
                table=arrays[p + "table"]))
        else:
            out.append(PackedStage(**common, coef=arrays[p + "coef"]))
    return PackedStages(stages=out,
                        out_cols=np.asarray(stages.out_cols, np.int64),
                        n_cols0=out[0].n_cols if out else 0)


def _stages_from_arrays(arrays: Dict[str, np.ndarray]) -> FusedStages:
    """Rebuild the v2 stage IR written by :func:`_data_arrays`."""
    n = int(arrays["fused/n_stages"][0])
    stages = []
    for k in range(n):
        p = f"fused/stage{k}_"
        kind_idx, n_cols = (int(v) for v in arrays[p + "kind"])
        kind = _STAGE_KINDS[kind_idx]
        epilogue = []
        for m in range(int(arrays[p + "n_epi"][0])):
            op_idx, mode_idx = (int(v) for v in arrays[p + f"epi{m}_op"])
            epilogue.append(EpiOp(op=_EPI_OPS[op_idx],
                                  mode=_MODE_CODES[mode_idx],
                                  params=arrays[p + f"epi{m}_params"]))
        common = dict(kind=kind, gather=arrays[p + "gather"], n_cols=n_cols,
                      bias=arrays[p + "bias"], epilogue=epilogue)
        if kind == "lut":
            stages.append(FusedStage(
                **common, in_shift=arrays[p + "in_shift"],
                mask=arrays[p + "mask"], table=arrays[p + "table"],
                out_shift=arrays[p + "out_shift"]))
        else:
            stages.append(FusedStage(
                **common, shifts=arrays[p + "shifts"],
                signs=arrays[p + "signs"]))
    return FusedStages(stages=stages, out_cols=arrays["fused/out_cols"])


def save_artifact(path: str, prog: DaisProgram, *,
                  stages: Optional[FusedStages] = None,
                  packed: Optional[PackedStages] = None,
                  compose: bool = True,
                  attestation: Optional[dict] = None) -> str:
    """Write an atomic bundle; returns its content hash.

    ``stages``: pass the already-composed fused tables if the caller built
    an engine anyway; with ``compose=True`` (default) they are composed here
    when omitted — programs that don't fit the fused pattern simply store no
    ``fused/*`` payload and rebuild on the generic path.

    ``packed``: kernel B4's packed chain; when omitted it is derived
    here with canonical int64 packing (wrap-identical for any program the
    int32 engine legally runs).  A chain that cannot pack (negative shifts,
    residency budget) stores no ``packed/*`` payload — the bundle still
    loads, and an ``engine="pallas"`` build degrades exactly as a fresh
    compile would.

    ``attestation``: the dict returned by ``verify_engine`` — stored in the
    bundle metadata as the proof-of-verification that
    ``--skip-verify-cached`` trusts.
    """
    if stages is None and compose:
        # range analysis feeds the composer's lane-narrowing masks so the
        # stored packed/* payload is as narrow as a fresh compile's
        try:
            from repro_torch.core.analysis import analyze_ranges
            ranges = analyze_ranges(prog)
        except Exception as e:
            logger.debug("bundle %s: range analysis unavailable (%s)",
                         path, e)
            ranges = None
        stages, _reason = compose_fused_stages(prog, ranges=ranges)
    if packed is None and stages is not None:
        try:
            packed = pack_stages(stages)
        except PackError as e:
            logger.info("bundle %s: no packed payload (%s)", path, e)
    arrays = _data_arrays(prog, stages)
    if packed is not None:
        arrays.update(_packed_arrays(packed))
    meta_core = {
        "format_version": FORMAT_VERSION,
        "fused": stages is not None,
        "packed": packed is not None,
        "attestation": attestation,
    }
    digest = _bundle_digest(arrays, meta_core)
    meta = {**meta_core, "content_hash": digest}
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return digest


@dataclasses.dataclass
class LoadedArtifact:
    prog: DaisProgram
    stages: Optional[FusedStages]
    meta: dict
    content_hash: str    # recomputed at load == meta["content_hash"]
    packed: Optional[PackedStages] = None   # v3 packed-chain payload

    @property
    def attestation(self) -> Optional[dict]:
        return self.meta.get("attestation")


def load_artifact(path: str) -> LoadedArtifact:
    """Read + integrity-check a bundle.

    Raises :class:`ArtifactError` when the file is missing a payload, has an
    unknown format version, or — the tamper case — the recomputed content
    hash of the data arrays differs from the one recorded at save time.

    The deserialized program is additionally run through the structural
    verifier (``core/analysis.py``): the content hash only proves the bytes
    are the ones saved, not that they encode a well-formed program — a
    bundle written by a buggy producer (or hand-edited with the digest
    recomputed) is rejected here with located lint diagnostics instead of
    failing deep inside an engine lowering.
    """
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, ValueError, zipfile.BadZipFile) as e:
        raise ArtifactError(f"cannot read artifact bundle {path!r}: {e}")
    if "meta_json" not in arrays:
        raise ArtifactError(f"{path!r} has no meta_json — not a bundle")
    meta = json.loads(bytes(arrays.pop("meta_json")).decode())
    version = meta.get("format_version")
    if version not in _SUPPORTED_VERSIONS:
        raise ArtifactError(
            f"{path!r}: format_version {version} "
            f"(this reader understands {_SUPPORTED_VERSIONS})")
    meta_core = {k: v for k, v in meta.items() if k != "content_hash"}
    digest = _bundle_digest(arrays, meta_core)
    if digest != meta.get("content_hash"):
        raise ArtifactError(
            f"{path!r}: content hash mismatch — bundle was modified after "
            f"save (stored {meta.get('content_hash')!r}, actual {digest!r}); "
            f"refusing to serve it")

    prog = DaisProgram.from_arrays(
        {k[len("prog/"):]: v for k, v in arrays.items()
         if k.startswith("prog/")})
    from repro_torch.core.analysis import VerifyError, verify_program
    try:
        verify_program(prog)
    except VerifyError as e:
        raise ArtifactError(
            f"{path!r}: bundle program fails the structural verifier — "
            f"refusing to serve it\n{e}") from e
    stages = None
    packed = None
    if meta.get("fused") and version >= 2:
        stages = _stages_from_arrays(arrays)
        if meta.get("packed") and version >= 3:
            packed = _packed_from_arrays(arrays, stages)
    elif meta.get("fused"):
        # backward-compat rule: v1 bundles stay loadable and bit-exact, but
        # their pre-v2 fused layout is superseded — drop it and let
        # build_engine recompose stages from the (versioned) program
        logger.info("v1 bundle %s: legacy fused payload ignored; stages "
                    "will be recomposed from the program", path)
    return LoadedArtifact(prog=prog, stages=stages, meta=meta,
                          content_hash=digest, packed=packed)


def build_engine(art: LoadedArtifact, *, device="cuda",
                 engine: Optional[str] = None) -> ServeEngine:
    """Deprecated: use ``repro_torch.serve.api.build(art, EngineSpec(...))``.

    The pre-façade spelling of bundle cold-start (stored ``fused/*`` stages
    and ``packed/*`` payload straight into ``compile_program``: no
    re-lowering, no composition).  It still works, bit-identically, but
    emits a :class:`DeprecationWarning`: the façade adds the verify policy,
    the require-flags and provenance in one call.
    """
    import warnings

    warnings.warn(
        "build_engine(art, ...) is deprecated; use repro_torch.serve.api."
        "build(art, EngineSpec(engine=..., verify=...)).engine",
        DeprecationWarning, stacklevel=2)
    return compile_program(art.prog, device=device, stages=art.stages,
                           engine=engine, packed=art.packed)
