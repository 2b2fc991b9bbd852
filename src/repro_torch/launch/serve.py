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

``--dce`` runs dead-cell elimination (``core/opt.py``) before compiling and
gates the optimized engine against the unoptimized interpreter; ``--lint``
prints the static-analysis report (``launch/lint.py``) of the lowered
program; ``--verify-rtl`` emits the served program's Verilog, simulates it
(``core/rtl_sim.py``) and asserts RTL == interpreter == engine on the
gate's rows.

Float32 matmuls and convolutions are held to full precision: TF32 is
switched off for both, so no path rounds through TF32.

Usage (the paper's JSC-HLF model at its real widths)::

    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --lut-dims 16,20,5 --lut-hidden 8 --batch 16600 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine pallas \\
        --model pid-hybrid --ctx 100 --batch 1024 --dce --lint --verify-rtl
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=("tables", "pallas"), default="tables",
                    help="tables: fused per-stage engine; pallas: the "
                         "one-launch packed chain (kernel B4) preferred")
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
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--gen", type=int, default=8,
                    help="request batches to serve")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--require-pallas", action="store_true",
                    help="imply --engine pallas and exit unless the packed "
                         "chain actually compiled")
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
    args = ap.parse_args(argv)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.require_pallas:
        args.engine = "pallas"
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")

    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.serve.api import EngineRequirementError, EngineSpec, build

    t0 = time.monotonic()
    prog, what = build_model_program(args, device)
    t_lower = time.monotonic() - t0
    if args.lint:
        from repro_torch.launch.lint import lint_program
        lint_program(prog, name=what)

    spec = EngineSpec(engine="pallas" if args.engine == "pallas" else "fused",
                      require="pallas" if args.require_pallas else None,
                      optimize=args.dce, verify="full",
                      verify_rtl=args.verify_rtl, n_random=2048, seed=args.seed)
    try:
        built = build(prog, spec, device=device)
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
          f"device={device}{pk}")
    print(f"[serve] bit-exact gate PASSED: {gate['random']} random + "
          f"{gate['exhaustive']} exhaustive rows vs DaisProgram.run "
          f"(lower {t_lower:.2f}s, gate {built.timings['gate_s']:.2f}s)")
    if args.verify_rtl:
        rtl = gate["rtl"]
        print(f"[serve] rtl gate PASSED: {rtl['verdict']} three ways (RTL sim "
              f"== DAIS interpreter == {rtl['engine_path']} engine) over "
              f"{rtl['random']} random + {rtl['exhaustive']} exhaustive rows "
              f"({rtl['n_wires']} wires, verilog sha256 "
              f"{rtl['verilog_sha256'][:12]}, {built.timings['rtl_s']:.2f}s)")

    lo, hi = input_code_bounds(prog)
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


if __name__ == "__main__":
    main()
