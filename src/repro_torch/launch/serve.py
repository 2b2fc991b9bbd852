"""Serving launcher of the port: a LUT-Dense stack as a verified integer engine.

The model (random weights from ``--seed``) is built on ``--device``, its
truth tables are extracted, the stack is lowered to a DAIS program, and the
program is compiled to a serving engine behind the bit-exact
``verify_engine`` gate; then one pre-formed batch of random in-range codes
is served ``--gen`` times and checked against ``DaisProgram.run``.

``--model pid-hybrid`` swaps the stack for the paper's hybrid conv PID model
(``models/pid.py``: HGQ conv front, two LUT convs, LUT head, window sum),
untrained from ``--seed``, lowered over a ``--ctx``-sample waveform context
(a multiple of the 20-sample DAQ window).  At one window (``--ctx 20``) the
program does not compose into fused stages, and it serves on the generic
op-group runner, as in the reference.

``--engine pallas`` prefers the one-launch packed chain (kernel B4); a chain
that cannot pack degrades to the fused path, and a program that does not
compose to the generic one, each with an ``EnginePathWarning`` (its reason
is printed too); ``--require-pallas`` turns that into a hard exit.
``--engine tables`` prefers the fused path.

``--engine float`` serves an LM config instead (``--arch``, ``--smoke``):
random parameters from ``--seed``, a batched prefill of ``--prompt-len``
random tokens, KV caches of ``prompt_len + gen`` positions, then greedy
``decode_step`` (``train/steps.py::make_prefill``/``make_decode_step``).
Its defaults are the reference's, ``--batch 4 --prompt-len 32 --gen 16``;
the integer engines keep ``--batch 1024 --gen 8``.  Any family of the zoo
serves (decoders' KV caches, Zamba2's states and per-application KV,
RWKV-6's recurrent state, Whisper's self and cross caches and its stub
``frames``); the cache's bytes are printed by key, and a Whisper prompt +
generation past its ``MAX_DEC_POS`` positions is refused.

``--dce`` runs dead-cell elimination (``core/opt.py``) before compiling and
gates the optimized engine against the unoptimized interpreter; ``--lint``
prints the static-analysis report (``launch/lint.py``) of the lowered
program; ``--verify-rtl`` emits the served program's Verilog, simulates it
(``core/rtl_sim.py``) and asserts RTL == interpreter == engine on the
gate's rows.

``--artifact <path>`` persists and reuses the compiled bundle
(``serve/artifact.py``, the reference's wire format): when the file exists
the launcher cold-starts from it — no table extraction, lowering or
composition, and for ``--engine pallas`` no packing — and re-runs the gate,
or with ``--skip-verify-cached`` trusts the bundle's stored attestation
(protected by its content hash); otherwise it compiles, gates and saves
the bundle there.

``--serve-loop`` switches from one pre-formed batch to single requests:
the micro-batching scheduler (``serve/scheduler.py``) coalesces them into
padded power-of-two batches (``--max-batch``, ``--max-delay-ms``,
``--workers``) under open-loop traffic at ``--rate`` requests/s (0: one
burst), once over the engine and once over the numpy interpreter, and
reports p50/p99 latency and throughput; every response is checked against
``DaisProgram.run``.  ``--replicas N`` (N > 1) or ``--models a.npz,b.npz``
serve through the replica tier (``serve/tier.py``) instead, every bundle a
model named by its file stem, with ``--max-queue``, ``--overload-policy``
and ``--slo-ms``; each response is checked against its own model's
interpreter.  On one card the replicas time-multiplex.

Float32 matmuls and convolutions are held to full precision: TF32 is
switched off for both, so no path rounds through TF32.

Usage (the paper's JSC-HLF model at its real widths)::

    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --lut-dims 16,20,5 --lut-hidden 8 --batch 16600 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --model pid-hybrid --ctx 100 --batch 1024 --dce --lint --verify-rtl
    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --artifact jsc.npz --skip-verify-cached --serve-loop --rate 2000
    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --models jsc.npz,pid.npz --replicas 2 --rate 0
    PYTHONPATH=src python -m repro_torch.launch.serve --engine float \\
        --arch olmo_1b --batch 4 --prompt-len 32768 --gen 32
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_lut_stack(dims, hidden: int, *, device, generator):
    """The LUT-Dense stack of ``dims`` with batch-norm on the first layer,
    as ``benchmarks/table2_jsc_hlf.py`` builds the JSC-HLF model."""
    from repro_torch.core.lut_layers import LUTDense

    return [LUTDense(ci, co, hidden=hidden, use_batchnorm=(k == 0),
                     device=device, generator=generator)
            for k, (ci, co) in enumerate(zip(dims[:-1], dims[1:]))]


def build_model_program(args, device):
    """Lower the model of ``args`` (untrained, from ``args.seed``) to a DAIS
    program; returns it with a one-line description."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "pid-hybrid":
        from repro_torch.core.lower import lower
        from repro_torch.models.pid import build_pid_graph, build_pid_layers

        layers = build_pid_layers(hidden=args.lut_hidden, device=device,
                                  generator=gen)
        try:
            graph = build_pid_graph(layers, n_samples=args.ctx)
        except ValueError as e:
            raise SystemExit(str(e))
        return lower(graph), f"model=pid-hybrid ctx={args.ctx}"

    from repro_torch.core.lower import compile_sequential

    dims = [int(d) for d in args.lut_dims.split(",")]
    if len(dims) < 2:
        raise SystemExit("--lut-dims needs at least in,out (e.g. 16,5)")
    layers = build_lut_stack(dims, args.lut_hidden, device=device, generator=gen)
    return (compile_sequential(layers, args.in_f, args.in_i),
            f"model=lut-stack dims={dims}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("tables", "pallas", "float"), default="tables",
                    help="tables: fused per-stage engine; pallas: the "
                         "one-launch packed chain (kernel B4) preferred; "
                         "float: an LM config (--arch), prefill + greedy decode")
    ap.add_argument("--arch", default=None,
                    help="LM arch config (required for --engine float)")
    ap.add_argument("--smoke", action="store_true",
                    help="--engine float: the arch's reduced config")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="--engine float: prompt tokens a sequence")
    ap.add_argument("--model", choices=("lut-stack", "pid-hybrid"),
                    default="lut-stack",
                    help="lut-stack: LUT-Dense chain from --lut-dims; "
                         "pid-hybrid: the paper's hybrid conv PID model")
    ap.add_argument("--ctx", type=int, default=100,
                    help="pid-hybrid waveform context length in samples "
                         "(multiple of the 20-sample DAQ window)")
    ap.add_argument("--lut-dims", default="16,20,5",
                    help="comma-separated layer widths of the LUT-Dense stack")
    ap.add_argument("--lut-hidden", type=int, default=8)
    ap.add_argument("--in-f", type=int, default=4,
                    help="fractional bits of the request input grid")
    ap.add_argument("--in-i", type=int, default=2,
                    help="integer bits of the request input grid")
    ap.add_argument("--batch", type=int, default=None,
                    help="rows a request batch (default 1024); sequences "
                         "with --engine float (default 4)")
    ap.add_argument("--gen", type=int, default=None,
                    help="request batches to serve (default 8); tokens to "
                         "generate with --engine float (default 16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--require-pallas", action="store_true",
                    help="imply --engine pallas and exit unless the packed "
                         "chain actually compiled")
    ap.add_argument("--require-fused", action="store_true",
                    help="exit unless the engine compiled on the fused path "
                         "or better (no downgrade to the generic runner)")
    ap.add_argument("--dce", action="store_true",
                    help="run dead-cell elimination (core/opt.py) before "
                         "compiling; the gate then checks the optimized "
                         "engine against the UNoptimized interpreter")
    ap.add_argument("--lint", action="store_true",
                    help="print the static-analysis report (launch/lint.py) "
                         "of the lowered program before serving it")
    ap.add_argument("--verify-rtl", action="store_true",
                    help="emit the served program's Verilog, simulate it and "
                         "assert RTL == interpreter == engine")
    ap.add_argument("--artifact", default=None,
                    help="bundle path: load it when present, else compile "
                         "and save it there")
    ap.add_argument("--skip-verify-cached", action="store_true",
                    help="trust a loaded bundle's stored attestation "
                         "(content-hash protected) instead of re-running "
                         "the bit-exactness gate")
    ap.add_argument("--serve-loop", action="store_true",
                    help="single requests through the micro-batching "
                         "scheduler under open-loop traffic (p50/p99 + "
                         "throughput, engine vs interpreter)")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered load of the traffic driver, requests/s "
                         "(0: one burst)")
    ap.add_argument("--requests", type=int, default=1024,
                    help="total requests the traffic driver submits")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="largest scheduler bucket (power of two)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="scheduler coalescing deadline per request")
    ap.add_argument("--workers", type=int, default=1,
                    help="scheduler engine-call threads")
    ap.add_argument("--replicas", type=int, default=1,
                    help="> 1: serve through the replica tier "
                         "(work-stealing replicas over a model registry)")
    ap.add_argument("--models", default=None,
                    help="comma-separated bundle paths to register and serve "
                         "together in one tier (names = file stems)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission bound: requests past this many pending "
                         "are rejected (or shed, per --overload-policy)")
    ap.add_argument("--overload-policy", choices=("reject", "shed-oldest"),
                    default="reject",
                    help="what happens at the --max-queue bound "
                         "(shed-oldest: the tier only)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="default request deadline; the tier coalesces "
                         "batches from deadline buckets, soonest first")
    args = ap.parse_args(argv)
    if args.overload_policy == "shed-oldest" and not (args.models or args.replicas > 1):
        ap.error("--overload-policy shed-oldest is a tier policy: "
                 "give --replicas N (N > 1) or --models")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.require_pallas:
        args.engine = "pallas"
    lm = args.engine == "float"
    if lm and args.require_fused:
        ap.error("--require-fused only applies to --engine tables/pallas")
    if lm and args.arch is None:
        ap.error("--arch is required with --engine float")
    if args.batch is None:
        args.batch = 4 if lm else 1024
    if args.gen is None:
        args.gen = 16 if lm else 8
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    if lm:
        return serve_float(args, device)
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    own_group = not dist.is_initialized()
    mesh = make_local_mesh(device.type)
    try:
        if args.models or args.replicas > 1:
            return serve_tier(args, device, mesh)
        built = _tables_engine(args, device, mesh)
        if args.serve_loop:
            return serve_loop(args, built.prog, built.engine)
        serve_batches(args, device, built)
    finally:
        if own_group:
            dist.destroy_process_group()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_float(args, device) -> dict:
    """``--engine float``: an LM of ``--arch`` with random parameters from
    ``--seed``, one batched prefill of ``--prompt-len`` random tokens into KV
    caches of ``prompt_len + gen`` positions (the reference pads them after
    the prefill; here they are allocated at that length), then greedy
    ``decode_step`` for ``gen - 1`` tokens.  Returns the generated tokens
    ``(batch, gen)``, the timings, the cache bytes (in all and by key), the
    peak device memory,
    kernel B1's launches by call (prefill, then each decode step), the model
    and the last logits."""
    from repro_torch.configs.base import get_config, get_smoke
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.train.steps import make_decode_step, make_prefill

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen_t = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen_t)
    total = args.prompt_len + args.gen
    limit = getattr(model, "max_positions", None)
    if limit is not None and total > limit:
        raise SystemExit(f"--prompt-len {args.prompt_len} + --gen {args.gen} = {total} "
                         f"positions: {cfg.name}'s decoder positions stop at {limit}")
    rng = np.random.default_rng(args.seed)
    batch = {}
    for k, v in model.input_specs(args.prompt_len, args.batch, "prefill").items():
        if v.dtype == torch.int32:
            a = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
            batch[k] = torch.as_tensor(a, device=device)
        else:
            batch[k] = torch.as_tensor(rng.normal(0, 1, v.shape), device=device).to(v.dtype)
    prefill, decode = make_prefill(model), make_decode_step(model)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    b1 = []

    def b1_since(before):
        b1.append(ops.launch_counts()["fake_quant"] - before)

    _sync(device)
    t0 = time.perf_counter()
    before = ops.launch_counts()["fake_quant"]
    logits, cache = prefill(batch, cache_len=total)
    b1_since(before)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    out_tokens = [tokens]
    t0 = time.perf_counter()
    for _ in range(args.gen - 1):
        before = ops.launch_counts()["fake_quant"]
        logits, cache = decode(cache, tokens)
        b1_since(before)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        out_tokens.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0

    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    # every state tensor of the cache, whatever the family's keys (the
    # 0-d position index aside)
    by_key = {k: t.numel() * t.element_size() for k, t in cache.items() if t.dim()}
    kv_bytes = sum(by_key.values())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill({args.prompt_len} tok)={t_prefill*1e3:.1f} ms  "
          f"decode={t_decode/max(args.gen-1,1)*1e3:.2f} ms/tok")
    print(f"[serve] cache {kv_bytes} bytes ({total} positions): "
          + ", ".join(f"{k} {v}" for k, v in by_key.items()))
    print(f"[serve] peak device "
          f"memory {peak} bytes; B1 launches: prefill {b1[0]}, decode "
          f"{sorted(set(b1[1:]))} a step")
    print(f"[serve] sample generations (token ids): {gen[0][:12].tolist()}")
    return {"tokens": gen, "prefill_s": t_prefill, "decode_s": t_decode,
            "kv_bytes": kv_bytes, "cache_bytes": by_key, "peak_bytes": peak, "b1_per_call": b1,
            "model": model, "logits": logits}


def _spec(args, mesh, *, verify: str, optimize: bool = False):
    from repro_torch.serve.api import EngineSpec

    require = ("pallas" if args.require_pallas
               else "fused" if args.require_fused else None)
    return EngineSpec(engine="pallas" if args.engine == "pallas" else "fused",
                      mesh=mesh, require=require, optimize=optimize, verify=verify,
                      verify_rtl=args.verify_rtl, n_random=2048, seed=args.seed)


def _report_rtl(built) -> None:
    rtl = built.attestation["rtl"]
    print(f"[serve] rtl gate PASSED: {rtl['verdict']} three ways (RTL sim "
          f"== DAIS interpreter == {rtl['engine_path']} engine) over "
          f"{rtl['random']} random + {rtl['exhaustive']} exhaustive rows "
          f"({rtl['n_wires']} wires, verilog sha256 "
          f"{rtl['verilog_sha256'][:12]}, {built.timings['rtl_s']:.2f}s)")


def _tables_engine(args, device, mesh=None):
    """Build (or cold-start) the verified engine per the CLI flags.

    ``--artifact`` file exists: ``build(path, spec)`` loads the bundle
    (content hash and structural verifier checked) and re-runs the gate, or
    with ``--skip-verify-cached`` trusts its stored attestation.  Otherwise
    ``build(prog, spec)`` compiles the model (``optimize=True`` under
    ``--dce``, gated against the unoptimized oracle) and, with
    ``--artifact``, saves the bundle for the next cold start.
    """
    from repro_torch.serve.api import EngineRequirementError, build
    from repro_torch.serve.artifact import save_artifact

    if args.artifact and os.path.exists(args.artifact):
        if args.dce:
            raise SystemExit(
                "--dce applies at compile time and cannot rewrite an "
                "existing bundle (its stages and attestation cover the "
                "stored program).  Delete the bundle (or point --artifact "
                "elsewhere) and re-run with --dce to save an optimized one.")
        spec = _spec(args, mesh, verify="cached" if args.skip_verify_cached else "full")
        try:
            built = build(args.artifact, spec, device=device)
        except EngineRequirementError as e:
            raise SystemExit(str(e))
        engine, att = built.engine, built.attestation
        print(f"[serve] artifact loaded: {args.artifact} "
              f"(hash {built.content_hash[:12]}, path={engine.path}, "
              f"dtype={str(engine.dtype).replace('torch.', '')}, "
              f"{built.timings['load_s'] + built.timings['compile_s']:.2f}s "
              f"— no re-lowering)")
        if "gate_s" in built.timings:
            print(f"[serve] bit-exact gate PASSED: {att['random']} random + "
                  f"{att['exhaustive']} exhaustive rows vs DaisProgram.run "
                  f"(gate {built.timings['gate_s']:.2f}s)")
        else:
            print(f"[serve] bit-exact gate SKIPPED: cached attestation "
                  f"({att.get('random')} random + {att.get('exhaustive')} "
                  f"exhaustive rows) verified by content hash")
        if args.lint:
            from repro_torch.launch.lint import lint_program
            lint_program(built.prog, name=args.artifact)
        if args.verify_rtl:
            _report_rtl(built)
        return built

    t0 = time.monotonic()
    prog, what = build_model_program(args, device)
    t_lower = time.monotonic() - t0
    if args.lint:
        from repro_torch.launch.lint import lint_program
        lint_program(prog, name=what)
    try:
        built = build(prog, _spec(args, mesh, verify="full", optimize=args.dce),
                      device=device)
    except EngineRequirementError as e:
        raise SystemExit(str(e))
    engine, gate, prog = built.engine, built.attestation, built.prog
    if args.dce:
        print(f"[serve] dce: {built.timings['dce_summary']}")
    if engine.fuse_reason:
        print(f"[serve] path downgraded to {engine.path!r}: {engine.fuse_reason}")
    pk = (f" launches={engine.n_launches} "
          f"packed_table_bytes={engine.packed_table_bytes}"
          if engine.path == "pallas" else "")
    print(f"[serve] {what} instrs={prog.n_instrs()} "
          f"path={engine.path} groups={engine.n_groups} "
          f"dtype={str(engine.dtype).replace('torch.', '')} "
          f"device={device} mesh={_mesh_shape(mesh)}{pk}")
    print(f"[serve] bit-exact gate PASSED: {gate['random']} random + "
          f"{gate['exhaustive']} exhaustive rows vs DaisProgram.run "
          f"(lower {t_lower:.2f}s, gate {built.timings['gate_s']:.2f}s)")
    if args.verify_rtl:
        _report_rtl(built)
    if args.artifact:
        digest = save_artifact(args.artifact, prog, attestation=gate)
        print(f"[serve] artifact saved: {args.artifact} "
              f"(hash {digest[:12]}, attestation stored)")
    return built


def serve_batches(args, device, built) -> None:
    """One pre-formed batch of random in-range codes, served ``--gen``
    times and checked against the oracle's ``DaisProgram.run``."""
    from repro_torch.kernels.lut_serve import input_code_bounds

    engine = built.engine
    lo, hi = input_code_bounds(built.prog)
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(lo, hi + 1, (args.batch, engine.n_inputs), np.int64)
    x = torch.as_tensor(codes, device=device).to(engine.dtype)
    engine.run(x)                                   # warm
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    n_batches = max(args.gen, 1)
    t0 = time.monotonic()
    for _ in range(n_batches):
        out = engine.run(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    ref = built.oracle.run(codes)
    if not np.array_equal(out.cpu().numpy().astype(np.int64), ref):
        raise SystemExit("[serve] engine output diverged from DaisProgram.run")
    print(f"[serve] {n_batches} batches x {args.batch} rows: "
          f"{dt / n_batches * 1e3:.3f} ms/batch  "
          f"({n_batches * args.batch / dt:,.0f} rows/s) on {device}")
    print(f"[serve] sample output codes (grid f={engine.output_f}): "
          f"{out[0].tolist()}")


def serve_loop(args, prog, engine) -> None:
    """Open-loop single-request traffic through the micro-batching scheduler.

    ``compare_under_load`` runs the identical driver twice — engine-backed,
    then interpreter-backed — and raises unless every response of both is
    bit-exact against ``DaisProgram.run``; p50/p99 latency and throughput
    are reported for both.
    """
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.serve.scheduler import ServeConfig, compare_under_load

    n = max(args.requests, 1)
    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(lo, hi + 1, (n, engine.n_inputs), np.int64)
    cfg = ServeConfig(max_batch=args.max_batch,
                      max_delay_ms=args.max_delay_ms,
                      n_workers=args.workers,
                      max_queue=args.max_queue,
                      overload_policy=args.overload_policy)
    print(f"[serve-loop] scheduler up: max_batch={cfg.max_batch} "
          f"deadline={cfg.max_delay_ms}ms workers={cfg.n_workers}")
    offered = (f"{args.rate:,.0f} req/s" if args.rate > 0
               else "max-rate burst")
    rows = {r["backend"]: r
            for r in compare_under_load(prog, engine, codes, cfg,
                                        rates=[args.rate])}
    for name, s in rows.items():
        print(f"[serve-loop] {name:>6}: {n} requests @ {offered}: "
              f"p50={s['p50_ms']:.2f} ms  p99={s['p99_ms']:.2f} ms  "
              f"throughput={s['rows_per_s']:,.0f} rows/s  "
              f"(batches={s['n_batches']}, "
              f"mean_fill={s['mean_batch_fill']:.1f}, "
              f"pad_overhead={s['pad_overhead'] * 100:.0f}%, "
              f"warmup {s['warmup_s']:.2f}s)")
    ratio = rows["engine"]["rows_per_s"] / rows["interp"]["rows_per_s"]
    print(f"[serve-loop] engine/interpreter throughput ratio: {ratio:.2f}x  "
          f"all {n} responses bit-exact vs DaisProgram.run")


def _mesh_shape(mesh):
    return None if mesh is None else tuple(mesh.shape)


def serve_tier(args, device, mesh=None) -> None:
    """Multi-replica, multi-model serving through the tier.

    ``--models a.npz,b.npz`` registers every bundle (names = file stems)
    into one model registry; without it the engine of the usual CLI flags
    serves as model ``"default"``.  Interleaved per-model requests are
    submitted at ``--rate`` (0 = burst), and every response is checked
    against *that model's* ``DaisProgram.run``.
    """
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.parallel.sharding import replica_meshes
    from repro_torch.serve.api import build, tier_from_built
    from repro_torch.serve.scheduler import RejectedError, ServeConfig
    from repro_torch.serve.tier import TierConfig

    built = {}
    if args.models:
        spec = _spec(args, mesh, verify="cached" if args.skip_verify_cached else "full")
        for path in args.models.split(","):
            name = os.path.splitext(os.path.basename(path))[0]
            built[name] = build(path, spec, device=device)
            print(f"[tier] registered {name!r}: hash "
                  f"{built[name].content_hash[:12]} "
                  f"path={built[name].engine.path}")
    else:
        built["default"] = _tables_engine(args, device, mesh)

    placements = replica_meshes(mesh, args.replicas)
    distinct = len({id(m) for m in placements})
    cfg = TierConfig(
        n_replicas=args.replicas,
        serve=ServeConfig(max_batch=args.max_batch,
                          max_delay_ms=args.max_delay_ms,
                          max_queue=args.max_queue,
                          slo_ms=args.slo_ms,
                          overload_policy=args.overload_policy))
    tier = tier_from_built(built, cfg)
    n_dev = 1 if mesh is None else mesh.size()
    print(f"[tier] up: {args.replicas} replicas on {device} "
          f"({'disjoint sub-meshes' if distinct > 1 else 'time-multiplexed'}), "
          f"mesh={_mesh_shape(mesh)} over {n_dev} device(s), models={sorted(built)}, "
          f"max_queue={args.max_queue}, policy={args.overload_policy}")

    n = max(args.requests, 1)
    rng = np.random.default_rng(args.seed)
    work = []                                  # (model, row, expected_row)
    per = max(n // len(built), 1)
    for name, b in built.items():
        lo, hi = input_code_bounds(b.prog)
        codes = rng.integers(lo, hi + 1, (per, b.engine.n_inputs), np.int64)
        ref = np.asarray(b.oracle.run(codes), np.int64)
        work += [(name, codes[i], ref[i]) for i in range(per)]
    order = rng.permutation(len(work))
    t0 = time.monotonic()
    flights, n_rejected = [], 0
    for k, idx in enumerate(order):
        name, row, ref = work[idx]
        if args.rate > 0:
            delay = (t0 + k / args.rate) - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        try:
            flights.append((tier.submit(row, name), name, ref))
        except RejectedError:
            n_rejected += 1
    mismatches = 0
    for fut, name, ref in flights:
        if not np.array_equal(np.asarray(fut.result(timeout=120), np.int64),
                              ref):
            mismatches += 1
    wall = time.monotonic() - t0
    s = tier.stats()
    tier.stop()
    if mismatches:
        raise SystemExit(f"[tier] {mismatches} responses diverged from "
                         f"their model's DaisProgram.run")
    offered = (f"{args.rate:,.0f} req/s" if args.rate > 0
               else "max-rate burst")
    print(f"[tier] {len(flights)} served @ {offered}: "
          f"p50={s.p50_ms:.2f} ms  p99={s.p99_ms:.2f} ms  "
          f"throughput={len(flights) / wall:,.0f} req/s  "
          f"(batches={s.n_batches}, stolen={s.n_stolen}, "
          f"rejected={n_rejected}, shed={s.n_shed}, "
          f"deadline_misses={s.deadline_misses}, "
          f"per-replica batches={list(s.per_replica_batches)})")
    print(f"[tier] per-model: {dict(sorted(s.per_model.items()))} — every "
          f"response bit-exact vs its model's interpreter")


if __name__ == "__main__":
    main()
