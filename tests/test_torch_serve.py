"""Port parity for serving: the engine, kernel B4's plain version, the
``build`` API and the launcher, all on the CPU.

* The port's engine, through the plain packed chain ("pallas" path) and the
  fused runner, in int32 and int64, matches the reference
  ``DaisProgram.run`` bit for bit on the JSC-HLF program.
* The plain B4 runner, given the reference's own packed pid-hybrid chain
  (lowered and packed by the JAX package, carried as numpy), matches the
  reference interpreter — sum stages, relu epilogues and the zero column.
* Path downgrades warn (``EnginePathWarning``), down to the generic runner
  for a program without segments; ``require=`` turns them into
  ``EngineRequirementError``, and the launcher runs end to end.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dais import DaisProgram as RefDaisProgram
from repro_torch.core.dais import DaisProgram
from repro_torch.core.lower import compile_sequential
from repro_torch.kernels import lut_serve_cuda
from repro_torch.kernels.lut_serve import (EnginePathWarning,
                                           EngineRequirementError, EpiOp,
                                           _check_dtype, compile_program,
                                           input_code_bounds, verify_engine)
from repro_torch.kernels.lut_serve_cuda import (PackedChain, PackedStage,
                                                PackedStages, PackError,
                                                run_chain, run_chain_plain)
from repro_torch.launch.serve import build_lut_stack, main
from repro_torch.serve.api import EngineSpec, build

torch.set_num_threads(2)

IN_F, IN_I = 4, 2


@pytest.fixture(scope="module")
def jsc():
    """The port-lowered JSC-HLF program and the reference's reading of it."""
    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    prog = compile_sequential(layers, IN_F, IN_I)
    return prog, RefDaisProgram.from_arrays(prog.to_arrays())


@pytest.fixture(scope="module")
def pid():
    """The reference's hybrid PID program and its packed chain (int32)."""
    from repro.core.analysis import analyze_ranges
    from repro.core.lower import lower
    from repro.kernels.lut_serve import compose_fused_stages
    from repro.kernels.lut_serve_pallas import pack_stages
    from repro.models.pid import (build_pid_graph, build_pid_layers,
                                  init_pid_params)

    layers = build_pid_layers(hidden=4)
    params = init_pid_params(layers, jax.random.PRNGKey(5))
    prog = lower(build_pid_graph(layers, n_samples=40), [*params, None])
    stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    assert stages is not None, why
    return prog, pack_stages(stages, jnp.int32)


def _codes(prog, n, seed):
    lo, hi = input_code_bounds(prog)
    return np.random.default_rng(seed).integers(lo, hi + 1, (n, len(lo)))


@pytest.mark.parametrize("engine", ["pallas", "fused"])
@pytest.mark.parametrize("dtype", [None, torch.int64])
def test_engine_matches_reference_interpreter(jsc, engine, dtype):
    prog, ref = jsc
    eng = compile_program(prog, device="cpu", engine=engine, dtype=dtype)
    assert eng.path == engine and eng.fuse_reason == ""
    assert eng.dtype == (dtype or torch.int32)          # proven width 9 bits
    if engine == "pallas":
        assert eng.n_launches == 1 and eng.packed_table_bytes == 215040
    codes = _codes(prog, 4096, seed=1)
    got = eng.run(codes)
    assert got.dtype == eng.dtype and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().astype(np.int64), ref.run(codes))


def _port_packed(ref_packed) -> PackedStages:
    """The reference's PackedStages, carried field by field as numpy."""
    stages = [PackedStage(
        kind=s.kind, gather=np.asarray(s.gather), n_cols=int(s.n_cols),
        bias=np.asarray(s.bias),
        epilogue=[EpiOp(e.op, e.mode, np.asarray(e.params)) for e in s.epilogue],
        in_shift=None if s.in_shift is None else np.asarray(s.in_shift),
        mask=None if s.mask is None else np.asarray(s.mask),
        table=None if s.table is None else np.asarray(s.table),
        coef=None if s.coef is None else np.asarray(s.coef))
        for s in ref_packed.stages]
    return PackedStages(stages, np.asarray(ref_packed.out_cols),
                        int(ref_packed.n_cols0))


def test_plain_chain_runs_reference_pid_packing(pid):
    prog, ref_packed = pid
    packed = _port_packed(ref_packed)
    kinds = [s.kind for s in packed.stages]
    assert "sum" in kinds and "lut" in kinds
    assert any(bool((s.gather >= s.n_cols).any()) for s in packed.stages)
    assert any(s.epilogue for s in packed.stages)
    chain = PackedChain(packed, torch.int32, "cpu")
    codes = _codes(prog, 1024, seed=2)
    got = run_chain(chain, torch.as_tensor(codes, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), prog.run(codes))


def test_port_engine_on_reference_pid_program(pid):
    ref, _ = pid
    prog = DaisProgram.from_arrays(ref.to_arrays())
    eng = compile_program(prog, device="cpu", engine="pallas")
    assert eng.path == "pallas"
    att = verify_engine(eng, prog, n_random=512)
    assert att["random"] == 512
    codes = _codes(prog, 256, seed=3)
    np.testing.assert_array_equal(eng.run(codes).numpy().astype(np.int64),
                                  ref.run(codes))


def test_pack_budget_and_downgrade(jsc, monkeypatch):
    prog, _ref = jsc
    from repro_torch.kernels.lut_serve import compose_fused_stages

    stages, _ = compose_fused_stages(prog)
    with pytest.raises(PackError):
        lut_serve_cuda.pack_stages(stages, torch.int32, vmem_budget=1024)

    def refuse(*args, **kwargs):
        raise PackError("forced for the test")

    monkeypatch.setattr(lut_serve_cuda, "pack_stages", refuse)
    with pytest.warns(EnginePathWarning, match="forced for the test"):
        eng = compile_program(prog, device="cpu", engine="pallas")
    assert eng.path == "fused" and "forced for the test" in eng.fuse_reason
    with pytest.raises(EngineRequirementError, match="require='pallas'"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", EnginePathWarning)
            build(prog, EngineSpec(engine="pallas", require="pallas"),
                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", EnginePathWarning)
        built = build(prog, EngineSpec(engine="pallas", require="fused",
                                       n_random=256), device="cpu")
    assert built.engine.path == "fused" and built.attestation["random"] == 256


def test_build_gate_and_spec(jsc):
    prog, _ref = jsc
    with warnings.catch_warnings():
        warnings.simplefilter("error", EnginePathWarning)   # no downgrade
        built = build(prog, EngineSpec(engine="pallas", require="pallas",
                                       n_random=512), device="cpu")
    assert built.engine.path == "pallas"
    assert built.attestation == {"random": 512, "exhaustive": 0,
                                 "max_width": prog.max_width(), "n_groups": 2}
    skipped = build(prog, EngineSpec(verify="skip"), device="cpu")
    assert skipped.attestation is None and "gate_s" not in skipped.timings
    # on a program, "cached" (the default, as the reference's) is the full gate
    cached = build(prog, EngineSpec(engine="pallas", n_random=512), device="cpu")
    assert cached.attestation == built.attestation and "gate_s" in cached.timings
    assert cached.content_hash is None and cached.source is None
    with pytest.raises(ValueError):
        EngineSpec(verify="maybe")
    with pytest.raises(ValueError):
        EngineSpec(require="groups")
    with pytest.raises(TypeError, match="bundle path"):
        build(prog.to_arrays(), device="cpu")


def test_gate_catches_a_wrong_engine(jsc):
    prog, _ref = jsc
    eng = compile_program(prog, device="cpu", engine="pallas")
    runner = eng._runner
    bad = dataclasses.replace(eng, _runner=lambda x: runner(x) + 1)
    with pytest.raises(AssertionError, match="DAIS interpreter"):
        verify_engine(bad, prog, n_random=64)


def test_unported_paths_and_dtypes_raise(jsc):
    """The flat program (no segments) now serves on the generic runner with
    its warning, as the reference's does; the dtype checks stay."""
    prog, ref = jsc
    flat = DaisProgram.from_arrays(prog.to_arrays())
    flat.segments = []                       # the reference's generic path
    with pytest.warns(EnginePathWarning, match="fused unavailable: program has no "
                                               "segment metadata"):
        eng = compile_program(flat, device="cpu", engine="fused")
    assert eng.path == "generic" and eng.n_groups == len(flat.schedule())
    codes = _codes(prog, 512, seed=9)
    np.testing.assert_array_equal(eng.run(codes).numpy().astype(np.int64), ref.run(codes))
    with pytest.raises(ValueError, match="unknown engine"):
        compile_program(prog, device="cpu", engine="tables")
    with pytest.raises(ValueError, match="overflow"):
        _check_dtype(torch.int32, 31)
    _check_dtype(torch.int64, 40)
    with pytest.raises(ValueError):
        compile_program(prog, device="cpu", dtype=torch.int16)


def test_wrappers_raise_off_cpu_and_cuda(jsc):
    from repro_torch.kernels.lut_dense import lut_dense_fused

    prog, _ref = jsc
    from repro_torch.kernels.lut_serve import compose_fused_stages

    stages, _ = compose_fused_stages(prog)
    chain = PackedChain(lut_serve_cuda.pack_stages(stages, torch.int32),
                        torch.int32, "cpu")
    meta = torch.empty((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        run_chain(chain, meta)
    x = torch.empty((4, 3), device="meta")
    w = torch.empty((3, 2, 5), device="meta")
    g = torch.empty((3, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lut_dense_fused(x, w, w, w, g, g, g, g, g)
    # the plain version is what a CPU tensor gets
    codes = torch.as_tensor(_codes(prog, 32, seed=4), dtype=torch.int32)
    assert torch.equal(run_chain(chain, codes), run_chain_plain(chain, codes))


@pytest.mark.parametrize("argv,path", [
    (["--engine", "pallas", "--require-pallas"], "pallas"),
    (["--engine", "tables"], "fused"),
])
def test_launcher_end_to_end_cpu(capsys, argv, path):
    main(argv + ["--device", "cpu", "--lut-dims", "16,20,5", "--lut-hidden", "8",
                 "--batch", "256", "--gen", "2"])
    out = capsys.readouterr().out
    assert f"path={path}" in out
    assert "bit-exact gate PASSED: 2048 random" in out
    assert "2 batches x 256 rows" in out


def test_launcher_artifact_serve_loop_and_tier(capsys, tmp_path):
    """``--artifact`` compiles, gates and saves, then cold-starts from the
    bundle (gate re-run, or trusted with ``--skip-verify-cached``) into the
    scheduler's serve loop; ``--models`` serves both bundles through the
    replica tier, every response checked against its model's interpreter."""
    jsc, pid = str(tmp_path / "jsc.npz"), str(tmp_path / "pid.npz")
    common = ["--device", "cpu", "--engine", "pallas", "--require-pallas"]
    main(common + ["--artifact", jsc, "--batch", "64", "--gen", "1"])
    out = capsys.readouterr().out
    assert f"artifact saved: {jsc}" in out and "2 batches" not in out
    main(common + ["--artifact", pid, "--model", "pid-hybrid", "--ctx", "40",
                   "--lut-hidden", "4", "--batch", "64", "--gen", "1"])
    assert f"artifact saved: {pid}" in capsys.readouterr().out
    main(common + ["--artifact", jsc, "--batch", "64", "--gen", "1"])
    out = capsys.readouterr().out
    assert "no re-lowering" in out and "bit-exact gate PASSED: 2048 random" in out
    main(common + ["--artifact", jsc, "--skip-verify-cached", "--serve-loop",
                   "--rate", "0", "--requests", "96", "--max-batch", "16"])
    out = capsys.readouterr().out
    assert "gate SKIPPED: cached attestation (2048 random" in out
    assert "[serve-loop] engine: 96 requests @ max-rate burst" in out
    assert "all 96 responses bit-exact vs DaisProgram.run" in out
    main(common + ["--models", f"{jsc},{pid}", "--skip-verify-cached",
                   "--replicas", "2", "--rate", "0", "--requests", "128",
                   "--max-batch", "16", "--max-queue", "1000"])
    out = capsys.readouterr().out
    assert "[tier] registered 'jsc'" in out and "[tier] registered 'pid'" in out
    assert "[tier] up: 2 replicas on cpu (time-multiplexed)" in out
    assert "[tier] 128 served @ max-rate burst" in out
    assert "{'jsc': 64, 'pid': 64} — every response bit-exact" in out
    main(["--device", "cpu", "--replicas", "2", "--rate", "0", "--requests", "32",
          "--lut-dims", "6,4,2", "--lut-hidden", "4"])
    assert "{'default': 32} — every response bit-exact" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--dce applies at compile time"):
        main(common + ["--artifact", jsc, "--dce"])


def test_launcher_refuses_shed_oldest_outside_the_tier(capsys):
    """``shed-oldest`` is a tier policy: the single-engine serve loop would
    accept it and still reject at ``--max-queue``, so the launcher refuses
    it unless ``--replicas`` or ``--models`` selects the tier."""
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "--serve-loop", "--max-queue", "8",
              "--overload-policy", "shed-oldest"])
    assert exc.value.code == 2
    assert "shed-oldest is a tier policy" in capsys.readouterr().err
