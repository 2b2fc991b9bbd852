#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA H100 (sm_90).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once), then runs these phases, each printing a
line:

1. device: the card's name and power limit (``nvidia-smi``) and the build;
2. kernel B1 (fake-quant) against its plain version on the card, bit for
   bit, in every width mode, at the train path's shape (16600, 16, 20) with
   widths (16, 20) and at odd sizes; timed beside its bound, its plain
   version and ``torch.fake_quantize_per_tensor_affine``;
3. kernel B2 (LUT-Dense forward) against its plain version at the JSC-HLF
   layer shapes 16->20 and 20->5, H=8, B=16600: code flips counted and
   bounded, both timed with CUDA events;
4. kernel B3 (recompute backward) against its plain version at the same
   shapes with pruned cells, within ``B3_REL``; two launches bitwise equal;
5. the serve slice, float: the 16,20,5 JSC-HLF stack from a seeded
   generator; its eval forward must equal ``DaisProgram.run_float`` of its
   own lowering exactly, and the fused forward (kernel B2) may differ from
   it only by a bounded count of output-grid flips;
6. the serve slice: ``build(prog, EngineSpec(engine="pallas",
   require="pallas", verify="full"))`` behind the bit-exact gate, then 8
   request batches each of 1024 and 16600 random in-range codes; each must
   match the plain chain bit for bit and launch kernel B4 exactly once;
7. the train slice: ``make_lut_train_step`` with ``lut_use_fused=True`` on
   JSC-HLF data for ``TRAIN_STEPS`` steps at B=16600, each launching B1
   twice, B2 once and B3 once; step 1 held against the same step through
   the plain versions (on the CPU, where the wrappers take them); a finite,
   falling loss; then the trained model evaluated, lowered (eval forward ==
   ``run_float`` exactly) and served through B4 behind the gate;
8. a seeded synthetic packed chain covering what JSC-HLF does not (sum
   stages, non-identity gathers with the zero column, in-shifts, CMUL and
   WRAP epilogues, int8/int16/int32/int64 lanes, int32 and int64 compute),
   kernel B4 against its plain version bit for bit;
9. the ``kernels`` JSON line, then the result line.

The launch counters are zeroed just before each path (phases 5-6 and phase
7, after its step-1 comparison) and read just after it: each path must have
launched each of its kernels.  Float32 matmuls and convolutions run without
TF32.  Any failure exits non-zero with no result line; so does a machine
without a CUDA device.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

SEED = 0
JSC_DIMS = (16, 20, 5)        # benchmarks/table2_jsc_hlf.py: 16 -> 20 -> 5
HIDDEN = 8
IN_F, IN_I = 4, 2             # launch/serve.py request grid
JSC_BATCH = 16600             # the JSC batch of repro/kernels/lut_dense.py
SERVE_BATCHES = (1024, 16600)
N_SERVE = 8
# B2 against its plain version: both run the same float32 ops in the same
# order on the card; only a tanh that differed in its last ulp could move a
# value across a rounding boundary of the output grid.  Allowed: at most
# 0.1% of outputs, each by at most two steps of its finest cell grid.
B2_FLIP_FRAC = 1e-3
# kernel B2 against the eval (einsum) forward: the fused path folds BN into
# the output projection, a different float rounding of the same function
FUSED_FLIP_FRAC = 1e-2
# B3 against its plain version: the same float32 expressions per element;
# only the sums over 16600 batch rows run in another order
B3_REL = 1e-4
# the train slice (examples/quickstart.py's hyperparameters)
TRAIN_STEPS = 200
TRAIN_IN_F, TRAIN_IN_I = 4, 3
N_TRAIN = 10 * JSC_BATCH
LR = 3e-3
# step 1 on the card against the CPU: a cell whose code flips (the CPU's and
# the card's tanh differ in the last ulp) moves its row's gradient terms, by
# at most about FLIP_GRAD / B each; other gradients hold to GRAD_RTOL of
# their tensor's largest magnitude plus GRAD_ATOL
FLIP_GRAD = 0.15
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-7
SHADOWED_RTOL = 1e-3
# ~0.1 s of device clock: longer than the host takes to enqueue any timed loop
HOST_AHEAD_CYCLES = 200_000_000
# train steps inside the torch.profiler window
PROFILE_STEPS = (100, 105)
# published H100 SXM peaks: HBM3 bandwidth and dense FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


class SmokeError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events).

    The stream first sleeps ``HOST_AHEAD_CYCLES`` clock cycles, so the host
    has enqueued every launch before the first one runs: the events then
    time the device's work back to back, not the host's enqueue rate (a
    wrapper's checks and allocations can take longer than its kernel)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flips(got, want, steps):
    """Outputs that differ, and the largest difference in output-grid steps."""
    diff = (got.double() - want.double()).abs()
    n = int((diff > 0).sum())
    return n, float((diff / steps).max()) if n else 0.0


# --------------------------------------------------------------------------- #
def phase_device():
    import torch
    from repro_torch.kernels import build as kbuild

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"kernels are built for sm_90a; device is sm_{cap[0]}{cap[1]}")
    t0 = time.monotonic()
    times = kbuild.build_all()
    wall = time.monotonic() - t0
    print("[build] nvcc -gencode arch=compute_90a,code=sm_90a: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in times.items())
          + f" (in parallel, {wall:.1f}s wall)")
    for name in kbuild.SOURCES:
        for ln in kbuild.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")
    return line


def b1_cases(rng, device):
    """B1 inputs in every width mode: (label, x, f, i, signed, overflow).

    The train path's two quantizers first (x (16600, 16, 20), per-cell
    widths (16, 20)), then per-tensor, per-channel, per-element and
    trailing-broadcast widths at odd sizes, unsigned, pruned widths, and an
    x that is not 16-byte aligned (the scalar path)."""
    import torch

    def widths(shape, signed):
        f = rng.integers(-3, 7, shape).astype(np.float32)
        i = rng.integers(-2, 5, shape).astype(np.float32)
        if shape:
            f.reshape(-1)[:2] = (-2.0, -3.0)      # pruned: width exactly 0, < 0
            i.reshape(-1)[:2] = (1.0 if signed else 2.0, 0.0)
        return (torch.as_tensor(f, device=device), torch.as_tensor(i, device=device))

    def values(shape, f, i):
        step = torch.exp2(-torch.broadcast_to(f, shape))
        top = torch.exp2(torch.broadcast_to(i, shape))
        k = torch.as_tensor(rng.integers(-60, 60, shape), device=device).float()
        pick = torch.as_tensor(rng.integers(0, 4, shape), device=device)
        wide = torch.as_tensor(rng.normal(0, 4, shape), device=device).float() * top
        x = torch.where(pick == 0, (k + 0.5) * step,             # half-grid ties
                        torch.where(pick == 1, top + (k % 3 - 1) * step / 2,
                                    torch.where(pick == 2, wide, k * step)))
        return x.float().contiguous()

    path = (JSC_BATCH, JSC_DIMS[0], JSC_DIMS[1])
    cases = []
    for label, shape, wshape, signed, overflow in (
            ("path WRAP in", path, path[1:], True, "WRAP"),
            ("path SAT out", path, path[1:], True, "SAT"),
            ("tensor", (4099, 7, 13), (), True, "SAT"),
            ("tensor unsigned", (4099, 7, 13), (), False, "WRAP"),
            ("channel", (4099, 7, 13), (13,), True, "WRAP"),
            ("channel unsigned", (4099, 7, 13), (13,), False, "SAT"),
            ("element", (333, 7, 13), (333, 7, 13), True, "SAT"),
            ("element unsigned", (333, 7, 13), (333, 7, 13), False, "WRAP"),
            ("trailing", (4099, 7, 13), (7, 13), False, "SAT"),
            ("trailing lead-1", (4099, 7, 13), (1, 7, 13), True, "WRAP")):
        f, i = widths(wshape, signed)
        cases.append((label, values(shape, f, i), f, i, signed, overflow))
    f, i = widths((13,), True)
    four, three = (torch.tensor(v, device=device) for v in (4.0, 3.0))
    flat = values((4099 * 13 + 1,), four, three)
    cases.append(("unaligned x", flat[1:].view(4099, 13), f, i, True, "SAT"))
    return cases


def phase_b1(device, report):
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_fused
    from repro_torch.kernels.ref import fake_quant_ref

    cases = b1_cases(np.random.default_rng(SEED + 4), device)
    for label, x, f, i, signed, overflow in cases:
        got = fake_quant_fused(x, f, i, signed=signed, overflow=overflow)
        torch.cuda.synchronize()
        want = fake_quant_ref(x, f, i, signed, overflow)
        n_bits = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check(torch.equal(got, want) and n_bits == 0,
              f"B1 {label}: {int((got != want).sum())} values and {n_bits} bit "
              f"patterns differ from the plain version")
        print(f"[B1] {label}: x {tuple(x.shape)}, widths {tuple(f.shape)}, "
              f"{'signed' if signed else 'unsigned'} {overflow}: identical to "
              f"the plain version, bit for bit ({x.numel()} values)")
    # time the path's input quantizer: WRAP over (16600, 16, 20), widths (16, 20)
    _, x, f, i, signed, overflow = cases[0]
    ms = cuda_ms(lambda: fake_quant_fused(x, f, i, signed=signed, overflow=overflow))
    plain_ms = cuda_ms(lambda: fake_quant_ref(x, f, i, signed, overflow))
    # yardstick: one PyTorch call computing B1's per-tensor signed SAT mode
    fs, is_ = 4, 3
    lib = lambda: torch.fake_quantize_per_tensor_affine(
        x, 2.0 ** -fs, 0, -2 ** (is_ + fs), 2 ** (is_ + fs) - 1)
    library_ms = cuda_ms(lib)
    mine = fake_quant_fused(x, torch.tensor(float(fs), device=device),
                            torch.tensor(float(is_), device=device), signed=True,
                            overflow="SAT")
    n_lib = int((lib() != mine).sum())
    b_ms, b_by = bound(2 * 4 * x.numel(), 15 * x.numel())
    print(f"[B1] path shape {tuple(x.shape)} WRAP, widths {tuple(f.shape)}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"torch.fake_quantize_per_tensor_affine (per-tensor SAT, same numel) "
          f"{library_ms:.4f} ms, differs from B1's per-tensor SAT in {n_lib} values")
    report["fake_quant"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": library_ms}


def phase_b2(device, report):
    import torch
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense import lut_dense_fused
    from repro_torch.kernels.ref import lut_dense_ref

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for k, (ci, co) in enumerate(zip(JSC_DIMS[:-1], JSC_DIMS[1:])):
        layer = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0),
                         device=device, generator=gen)
        args = layer.kernel_args()
        x = (torch.randn((JSC_BATCH, ci), generator=gen) * 4.0).to(device)
        got = lut_dense_fused(x, *args)
        torch.cuda.synchronize()
        want = lut_dense_ref(x, *args)
        check(got.shape == (JSC_BATCH, co) and bool(torch.isfinite(got).all()),
              f"B2 {ci}->{co}: bad output")
        step = torch.exp2(-args[6].max(dim=0).values)          # finest f_out
        n_flip, max_steps = flips(got, want, step)
        err = float((got - want).abs().max())
        check(n_flip <= B2_FLIP_FRAC * got.numel() and max_steps <= 2.0,
              f"B2 {ci}->{co}: {n_flip} outputs differ (max {max_steps} steps)")
        ms = cuda_ms(lambda: lut_dense_fused(x, *args))
        plain_ms = cuda_ms(lambda: lut_dense_ref(x, *args))
        n_bytes = 4 * (x.numel() + got.numel() + sum(a.numel() for a in args))
        # per cell: WRAP quant (~8 ops) + SAT quant (~6); per hidden unit:
        # mul, add, tanh (counted as one), mul, add
        n_ops = JSC_BATCH * ci * co * (5 * HIDDEN + 14)
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"[B2] {ci}->{co} H={HIDDEN} B={JSC_BATCH}: {n_flip} of "
              f"{got.numel()} outputs differ from the plain version "
              f"(max {max_steps} steps, max|err| {err}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows.append((ci, co, err, ms, plain_ms, b_ms, b_by))
    ci, co, err, ms, plain_ms, b_ms, b_by = rows[0]    # the wider layer
    report["lut_dense"] = {"max_abs_err": max(r[2] for r in rows), "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": None}


def b3_args(layer, rng, batch, device):
    """B3's inputs from a layer: its kernel arguments with a few cells
    pruned (total width <= 0), x and a cotangent g."""
    import torch

    args = [a.clone() for a in layer.kernel_args()]
    args[4][0, :2] = -1.0                     # f_in: WRAP width <= 0
    args[5][0, :2] = -1.0
    args[6][-1, -2:] = -1.0                   # f_out: SAT width exactly 0
    args[7][-1, -2:] = 0.0
    x = torch.as_tensor(rng.normal(0, 3, (batch, layer.c_in)), dtype=torch.float32,
                        device=device)
    g = torch.as_tensor(rng.normal(0, 1, (batch, layer.c_out)), dtype=torch.float32,
                        device=device)
    return x, args, g


B3_NAMES = ("dx", "dw0", "db0", "dw_out", "db_out", "df_in", "df_out", "di_out")


def b3_max_rel_err(got, want):
    """Largest |got - want| over each tensor's largest |want|, by name."""
    return {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(B3_NAMES, got, want)}


def phase_b3(device, report):
    import torch
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense import lut_dense_fused
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.kernels.ref import lut_dense_bwd_ref, lut_dense_ref

    gen = torch.Generator().manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for k, (ci, co) in enumerate(zip(JSC_DIMS[:-1], JSC_DIMS[1:])):
        layer = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0),
                         device=device, generator=gen)
        x, args, g = b3_args(layer, rng, JSC_BATCH, device)
        got = lut_dense_bwd_fused(x, *args, g)
        again = lut_dense_bwd_fused(x, *args, g)
        torch.cuda.synchronize()
        want = lut_dense_bwd_ref(x, *args, g)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, again))
        check(same, f"B3 {ci}->{co}: two launches on the same inputs differ")
        rel = b3_max_rel_err(got, want)
        worst = max(rel, key=rel.get)
        check(all(torch.isfinite(t).all() for t in got) and rel[worst] <= B3_REL,
              f"B3 {ci}->{co}: {worst} off by {rel[worst]:.3g} of its largest "
              f"magnitude (> {B3_REL})")
        # the forward it recomputes: B2 on the same inputs against its plain version
        n_flip, _ = flips(lut_dense_fused(x, *args), lut_dense_ref(x, *args),
                          torch.exp2(-args[6].max(dim=0).values))
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ms = cuda_ms(lambda: lut_dense_bwd_fused(x, *args, g))
        plain_ms = cuda_ms(lambda: lut_dense_bwd_ref(x, *args, g), iters=5, warmup=1)
        n_bytes = 4 * (2 * x.numel() + g.numel() + 2 * sum(a.numel() for a in args[:4])
                       + 2 * sum(a.numel() for a in args[4:]))
        # per (b, j, o): quantizers and surrogates ~30 ops; per hidden unit
        # ~16 (forward mul, add, tanh as one, mul, add; backward 11)
        n_ops = JSC_BATCH * ci * co * (16 * HIDDEN + 30)
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"[B3] {ci}->{co} H={HIDDEN} B={JSC_BATCH}, pruned cells: all eight "
              f"gradients within {B3_REL} of the plain version (worst {worst} "
              f"{rel[worst]:.3g}; max|err| {err:.3g}); dx off by {rel['dx']:.3g}; "
              f"recomputed forward flips vs plain {n_flip}; two launches "
              f"bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by})")
        rows.append((err, ms, plain_ms, b_ms, b_by))
    err, ms, plain_ms, b_ms, b_by = rows[1]           # the path's layer, 20->5
    report["lut_dense_bwd"] = {"max_abs_err": max(r[0] for r in rows), "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": None}


def phase_slice_float(device):
    import torch
    from repro_torch.core.lower import compile_sequential
    from repro_torch.launch.serve import build_lut_stack

    gen = torch.Generator().manual_seed(SEED)
    layers = build_lut_stack(list(JSC_DIMS), HIDDEN, device=device, generator=gen)
    rng = np.random.default_rng(SEED)
    w = IN_F + IN_I + 1
    codes = rng.integers(-(1 << (w - 1)), 1 << (w - 1), (JSC_BATCH, JSC_DIMS[0]))
    x_np = codes * 2.0 ** -IN_F
    x = torch.as_tensor(x_np, dtype=torch.float32, device=device)
    with torch.no_grad():
        y = x
        for layer in layers:
            y, _aux = layer(y)
        yf = x
        for layer in layers:
            yf = layer.apply_fused(yf)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    prog = compile_sequential(layers, IN_F, IN_I)
    t_lower = time.monotonic() - t0
    check(y.shape == (JSC_BATCH, JSC_DIMS[-1]) and bool(torch.isfinite(y).all()),
          "eval forward: bad output")
    ref = prog.run_float(x_np)
    exact = float(np.abs(y.cpu().numpy().astype(np.float64) - ref).max())
    check(exact == 0.0, f"eval forward != DaisProgram.run_float (max|d| {exact})")
    step = 2.0 ** -min(prog.output_f)
    n_flip, max_steps = flips(yf, y, step)
    check(n_flip <= FUSED_FLIP_FRAC * y.numel(),
          f"fused forward: {n_flip} outputs differ from the eval forward")
    ops = prog.count_ops()
    print(f"[slice-float] JSC-HLF {JSC_DIMS} H={HIDDEN} B={JSC_BATCH}: eval "
          f"forward == DaisProgram.run_float exactly; fused forward (B2) "
          f"differs in {n_flip} of {y.numel()} outputs (max {max_steps} steps "
          f"of 2^-{min(prog.output_f)}); lowered in {t_lower:.2f}s to "
          f"{prog.n_instrs()} instrs {ops}")
    return prog


def plain_chain(prog, engine, device):
    """The packed chain ``engine`` runs, rebuilt from ``prog`` for the plain
    version of B4 to run beside it."""
    from repro_torch.core.analysis import analyze_ranges
    from repro_torch.kernels.lut_serve import compose_fused_stages
    from repro_torch.kernels.lut_serve_cuda import PackedChain, pack_stages

    stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    check(stages is not None, why)
    packed = pack_stages(stages, engine.dtype)
    return PackedChain(packed, engine.dtype, device), packed


def phase_slice_serve(device, prog):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain
    from repro_torch.serve.api import EngineSpec, build

    built = build(prog, EngineSpec(engine="pallas", require="pallas",
                                   verify="full", n_random=2048, seed=SEED),
                  device=device)
    engine = built.engine
    att = built.attestation
    print(f"[slice-serve] verify_engine gate PASSED: {att['random']} random + "
          f"{att['exhaustive']} exhaustive rows vs DaisProgram.run; path="
          f"{engine.path} dtype={engine.dtype} stages={engine.n_groups} "
          f"packed_table_bytes={engine.packed_table_bytes} "
          f"(compile {built.timings['compile_s']:.2f}s, gate "
          f"{built.timings['gate_s']:.2f}s)")
    chain, packed = plain_chain(prog, engine, device)
    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(SEED + 2)
    xs, max_err = {}, 0
    for b in SERVE_BATCHES:
        times = []
        for k in range(N_SERVE):
            codes = rng.integers(lo, hi + 1, (b, engine.n_inputs), np.int64)
            x = torch.as_tensor(codes, device=device).to(engine.dtype)
            torch.cuda.synchronize()
            before = ops.launch_counts()["lut_serve"]
            t0 = time.perf_counter()
            out = engine.run(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(ops.launch_counts()["lut_serve"] == before + 1,
                  "B4 did not launch exactly once for a served batch")
            plain = run_chain_plain(chain, x)
            check(out.shape == (b, engine.n_outputs), f"B4: bad output at B={b}")
            max_err = max(max_err, int((out.long() - plain.long()).abs().max()))
            check(max_err == 0, f"B4 != plain chain at B={b}")
            if k == 0:
                check(np.array_equal(out.cpu().numpy().astype(np.int64),
                                     prog.run(codes)),
                      f"served batch != DaisProgram.run at B={b}")
        xs[b] = x
        print(f"[slice-serve] {N_SERVE} batches x {b} rows bit-exact vs the "
              f"plain chain (first also vs DaisProgram.run), one B4 launch "
              f"each; host batch times ms: "
              + " ".join(f"{t:.3f}" for t in times))
    return chain, xs, packed, max_err


def time_b4(chain, xs, packed, max_err, report):
    from repro_torch.kernels.lut_serve_cuda import run_chain, run_chain_plain

    x = xs[JSC_BATCH]
    b = x.shape[0]
    ms = cuda_ms(lambda: run_chain(chain, x))
    plain_ms = cuda_ms(lambda: run_chain_plain(chain, x))
    ms_small = cuda_ms(lambda: run_chain(chain, xs[SERVE_BATCHES[0]]))
    item = x.element_size()
    n_bytes = (item * b * (chain.n_in + chain.n_out) + packed.table_bytes()
               + int(chain.consts.numel()) * item)
    ops_row = 0
    for st in packed.stages:
        j_n = st.gather.shape[1]
        # per term: gather, (in-shift round ~8), mask, clamp, load, add;
        # sum stages: gather, multiply, add.  Then bias + epilogue ops.
        per_term = (4 + (8 if st.in_shift is not None else 0)
                    if st.kind == "lut" else 3)
        epi = sum(10 if e.op == "REQUANT" else 1 for e in st.epilogue)
        ops_row += st.n_sites * st.c_out * (j_n * per_term + 1 + epi)
    b_ms, b_by = bound(n_bytes, ops_row * b)
    print(f"[B4] JSC-HLF chain B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}); B={SERVE_BATCHES[0]}: kernel "
          f"{ms_small:.4f} ms")
    report["lut_serve"] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def train_setup(device):
    """The JSC-HLF train slice: layers, step, data and per-step batch indices
    (``examples/quickstart.py``'s configuration at the paper's batch)."""
    import torch
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.core.quant import int_to_float, quantize_to_int
    from repro_torch.data.synthetic import jsc_hlf
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.train.steps import TrainHParams

    steps, batch, n_train = TRAIN_STEPS, JSC_BATCH, N_TRAIN
    xtr, ytr = jsc_hlf(seed=SEED, n=n_train, split="train")
    xte, yte = jsc_hlf(seed=SEED, n=JSC_BATCH, split="test")
    ctr = quantize_to_int(xtr, TRAIN_IN_F, TRAIN_IN_I, True, "SAT")
    cte = quantize_to_int(xte, TRAIN_IN_F, TRAIN_IN_I, True, "SAT")
    data = {"x": torch.as_tensor(int_to_float(ctr, TRAIN_IN_F), dtype=torch.float32,
                                 device=device),
            "y": torch.as_tensor(ytr, device=device),
            "x_test": int_to_float(cte, TRAIN_IN_F).astype(np.float32),
            "codes_test": cte, "y_test": yte}
    idx = np.random.default_rng(SEED).integers(0, n_train, (steps, batch))
    data["idx"] = torch.as_tensor(idx, device=device)
    layers = build_lut_stack(list(JSC_DIMS), HIDDEN, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    hp = TrainHParams(adam=AdamConfig(lr=LR), beta=BetaSchedule(5e-7, 1e-4, steps),
                      lr_schedule=cosine_restarts(LR, first_period=max(steps // 2, 1),
                                                  warmup=min(30, steps // 2)),
                      lut_use_fused=True)
    return layers, hp, data


def train_batch(data, s):
    idx = data["idx"][s]
    return {"x": data["x"][idx], "y": data["y"][idx]}


def cell_flips(layers_a, layers_b, x):
    """Cells whose SAT output code differs between two copies of a stack
    (train-mode einsum cells, layer by layer on each copy's own input)."""
    import torch

    n = 0
    ha, hb = x, x.to(next(layers_b[0].parameters()).device)
    with torch.no_grad():
        for la, lb in zip(layers_a, layers_b):
            la.train(True)
            lb.train(True)
            ca, _ = la._cells(ha, True)
            cb, _ = lb._cells(hb, True)
            n += int((ca.cpu() != cb.cpu()).sum())
            ha, hb = torch.sum(ca, dim=-2), torch.sum(cb, dim=-2)
    return n


def compare_step_to_plain(layers, hp, batch):
    """One train step's loss and gradients on the card (the kernels) against
    the same step through the plain versions, which the wrappers take on the
    CPU.  Returns the CPU copy after its Adam step, the flip count and the
    worst gradient error over its tolerance."""
    import torch
    from repro_torch.train.steps import lut_loss_and_grads, make_lut_train_step

    cpu_layers = [copy.deepcopy(layer).to("cpu") for layer in layers]
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    n_flips = cell_flips(layers, cpu_layers, batch["x"])
    step0 = torch.zeros((), dtype=torch.int32)
    loss, ce, aux, grads = lut_loss_and_grads(layers, hp, step0, batch)
    closs, cce, caux, cgrads = lut_loss_and_grads(cpu_layers, hp, step0, cpu_batch)
    b = batch["x"].shape[0]
    for name, a, c in (("loss", loss, closs), ("ce", ce, cce),
                       ("ebops", aux.ebops, caux.ebops)):
        a, c = float(a.detach()), float(c.detach())
        check(abs(a - c) <= 1e-5 * abs(c) + 1e-6 + FLIP_GRAD / b * n_flips,
              f"train step 1: {name} {a} on the card vs {c} plain")
    # train-mode BN subtracts the batch mean, so the bias in front of it has
    # an exactly-zero gradient and both sides return the rounding noise of
    # sums over the batch: it is held to SHADOWED_RTOL of the BN bias
    # gradient, a sum of the same terms
    shadowed = {f"l{k}/b_out": f"l{k}/bn_bias"
                for k, layer in enumerate(layers) if layer.use_batchnorm}
    worst = 0.0
    for path, g in grads.items():
        w = cgrads[path]
        rtol = SHADOWED_RTOL if path in shadowed else GRAD_RTOL
        scale = float(cgrads[shadowed.get(path, path)].abs().max())
        tol = rtol * scale + GRAD_ATOL + FLIP_GRAD / b * n_flips
        err = float((g.cpu() - w).abs().max())
        worst = max(worst, err / tol)
        check(err <= tol, f"train step 1: gradient {path} off by {err} > {tol}")
    cpu_step, cpu_init = make_lut_train_step(cpu_layers, hp)
    cpu_step(cpu_init(), cpu_batch)
    return cpu_layers, n_flips, worst


def phase_train(device):
    """Part 1 of the train slice: step 1 against the plain versions (its
    launches are comparisons and are made before the path's window)."""
    layers, hp, data = train_setup(device)
    t0 = time.monotonic()
    cpu_layers, n_flips, worst = compare_step_to_plain(layers, hp, train_batch(data, 0))
    print(f"[train] step 1 at B={JSC_BATCH}: loss, CE, EBOPs and every gradient "
          f"on the card agree with the plain versions (CPU) within tolerance "
          f"(worst {worst:.3f} of it; {n_flips} cell codes flip between the "
          f"two; {time.monotonic() - t0:.1f}s)")
    return layers, hp, data, cpu_layers


def phase_train_run(device, layers, hp, data, cpu_layers):
    """Part 2, the path itself: TRAIN_STEPS fused steps, then evaluate, lower
    and serve the trained model."""
    import torch
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain
    from repro_torch.serve.api import EngineSpec, build
    from repro_torch.train.steps import make_lut_train_step, named_params

    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()
    per_step = {"fake_quant": 2, "lut_dense": 1, "lut_dense_bwd": 1, "lut_serve": 0}
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    metrics, host_ms = [], []
    prof_lo, prof_hi = PROFILE_STEPS
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for s in range(TRAIN_STEPS):
        if s == prof_lo:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = ops.launch_counts()
        batch = train_batch(data, s)
        t0 = time.perf_counter()
        events[s][0].record()
        opt, m = step_fn(opt, batch)
        events[s][1].record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if s == prof_hi - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            window_ms = events[prof_lo][0].elapsed_time(events[s][1])
            profile = trace_summary(prof, window_ms, prof_hi - prof_lo)
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == per_step, f"train step {s + 1} launched {got}, not {per_step}")
        metrics.append(torch.stack([m["loss"], m["ce"], m["ebops"]]))
        if s == 0:
            # Adam's first step is about sign(g)·lr: an element whose gradient
            # is within noise of 0 may land up to 2·lr apart
            card = named_params(layers)
            n_far = 0
            for path, p in named_params(cpu_layers).items():
                d = (card[path].detach().cpu() - p.detach()).abs()
                check(float(d.max()) <= 2 * LR + 1e-6,
                      f"train step 1: {path} moved {float(d.max())} from plain")
                n_far += int((d > 1e-3 * LR).sum())
            n_all = sum(p.numel() for p in card.values())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    dev_ms = [a.elapsed_time(b) for a, b in events]
    hist = torch.stack(metrics).cpu().numpy()
    check(bool(np.isfinite(hist).all()), "train: a non-finite loss, CE or EBOPs")
    ce_first, ce_last = float(hist[:10, 1].mean()), float(hist[-10:, 1].mean())
    check(ce_last < ce_first, f"train: CE did not fall ({ce_first} -> {ce_last})")
    # steady state: past the first 10 steps, outside the profiled window
    keep = [k for k in range(10, TRAIN_STEPS) if not prof_lo <= k < prof_hi]
    steady = [dev_ms[k] for k in keep]
    steady_host = [host_ms[k] for k in keep]
    print(f"[train] {TRAIN_STEPS} fused steps at B={JSC_BATCH}, each launching "
          f"B1 x2, B2 x1, B3 x1; step 1 params within 2*lr of plain ({n_far} of "
          f"{n_all} elements beyond 1e-3*lr); loss finite; mean CE first 10 "
          f"{ce_first:.4f} -> last 10 {ce_last:.4f}; EBOPs {hist[0, 2]:.0f} -> "
          f"{hist[-1, 2]:.0f}")
    print(f"[train] ms/step between CUDA events (steps 11-{TRAIN_STEPS} outside "
          f"the profiled window) mean {np.mean(steady):.4f} median "
          f"{np.median(steady):.4f}; host ms/step (enqueue) mean "
          f"{np.mean(steady_host):.4f}; {TRAIN_STEPS / wall:.2f} steps/s over the "
          f"whole loop ({wall:.3f}s, first step {dev_ms[0]:.3f} ms)")
    print(f"[train] torch.profiler, steps {prof_lo + 1}-{prof_hi}: {profile}")

    # evaluate, lower, serve the trained model
    for layer in layers:
        layer.eval()
    x_test = torch.as_tensor(data["x_test"], device=device)
    with torch.no_grad():
        logits = x_test
        for layer in layers:
            logits, _ = layer(logits)
    logits = logits.cpu().numpy().astype(np.float64)
    acc = float(np.mean(np.argmax(logits, -1) == data["y_test"]))
    prog = compile_sequential(layers, TRAIN_IN_F, TRAIN_IN_I)
    exact = float(np.abs(prog.run_float(data["x_test"]) - logits).max())
    check(exact == 0.0, f"trained eval forward != DaisProgram.run_float (max|d| {exact})")
    built = build(prog, EngineSpec(engine="pallas", require="pallas", verify="full",
                                   n_random=2048, seed=SEED), device=device)
    engine = built.engine
    chain, _ = plain_chain(prog, engine, device)
    codes = data["codes_test"]
    for lo in range(0, len(codes), 4096):
        c = torch.as_tensor(codes[lo:lo + 4096], device=device).to(engine.dtype)
        out = engine.run(c)
        torch.cuda.synchronize()
        check(torch.equal(out, run_chain_plain(chain, c)),
              "trained model: B4 != the plain chain")
        check(np.array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes[lo:lo + 4096])),
              "trained model: served batch != DaisProgram.run")
    print(f"[train] trained model: test accuracy {acc:.4f}; eval forward == "
          f"DaisProgram.run_float exactly on {len(codes)} rows; {prog.n_instrs()} "
          f"instrs; gate PASSED on path {engine.path}; {len(codes)} test rows "
          f"served through B4 bit-exact vs the plain chain and DaisProgram.run")
    return {"ms_step": float(np.mean(steady)), "host_ms_step": float(np.mean(steady_host)),
            "steps_per_s": TRAIN_STEPS / wall}


def trace_summary(prof, window_ms, n_steps):
    """Device busy time of the profiled steps, from the chrome trace: the
    share of the window the device ran kernels, the port's kernels' share,
    and the kernels that took the most device time."""
    from repro_torch.kernels import build as kbuild

    path = kbuild.BUILD_DIR / "train_trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh).get("traceEvents", [])
    kern = [e for e in trace if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]
    if not kern:
        return "no device kernels in the trace (device time not measured)"
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy = sum(by_name.values())
    mine = sum(v for k, v in by_name.items()
               if any(t in k for t in ("fake_quant_kernel", "lut_dense_forward_kernel",
                                       "lut_dense_bwd_")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"device busy {busy / n_steps:.4f} ms/step of {window_ms / n_steps:.4f} "
            f"ms/step between events (idle share {1 - busy / window_ms:.3f}); "
            f"{len(kern) // n_steps} device kernels per step; B1-B3 "
            f"{mine / n_steps:.4f} ms/step ({mine / busy:.3f} of busy); top: "
            + "; ".join(f"{k[:60]} {v / n_steps:.4f} ms" for k, v in top))


def synthetic_chain(rng, dtype):
    """A seeded packed chain with everything the JSC-HLF chain lacks."""
    import torch
    from repro_torch.kernels.lut_serve import EpiOp
    from repro_torch.kernels.lut_serve_cuda import PackedStage, PackedStages

    ed = np.int32 if dtype == torch.int32 else np.int64
    big_lane = np.int32 if dtype == torch.int32 else np.int64
    big = 2 ** 20 if dtype == torch.int32 else 2 ** 40

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int64)

    def requant(shape, wlo, whi, shift_lo, shift_hi, signed=None, apply=None):
        p = np.stack([ints(shift_lo, shift_hi + 1, shape), ints(wlo, whi + 1, shape),
                      ints(0, 2, shape) if signed is None else np.full(shape, signed),
                      ints(0, 2, shape) if apply is None else np.full(shape, apply)],
                     -1)
        return p.astype(np.int64)

    n_in = 12
    # lut: non-identity gather hitting the zero column, in-shifts, int16 lane
    s1, j1, c1, e1 = 3, 5, 4, 64
    g1 = ints(0, n_in + 1, (s1, j1))
    g1[0, 0] = n_in
    sh1 = ints(-3, 4, (j1, c1))
    sh1[0, 0] = -2
    st1 = PackedStage(
        "lut", g1, n_in, ints(-100, 100, (s1, c1)).astype(ed),
        [EpiOp("REQUANT", "SAT", requant((s1, c1), 8, 14, -2, 1, signed=1)),
         EpiOp("CMUL", "", ints(-3, 4, (s1, c1)))],
        in_shift=sh1, mask=(1 << ints(3, 7, (j1, c1))) - 1,
        table=ints(-2 ** 12, 2 ** 12, (j1, c1, e1)).astype(np.int16))
    # sum: zero column, signed shifted coefficients, WRAP epilogue
    w1 = s1 * c1
    s2, j2 = 6, 4
    g2 = ints(0, w1 + 1, (s2, j2))
    g2[1, 2] = w1
    coef = (ints(-1, 2, (s2, j2)) << ints(0, 3, (s2, j2))).astype(ed)
    st2 = PackedStage(
        "sum", g2, w1, ints(-50, 50, (s2, 1)).astype(ed),
        [EpiOp("REQUANT", "WRAP", requant((s2, 1), 6, 10, -1, 1, apply=1))],
        coef=coef)
    # lut: wide lane, no in-shift, masks past the (narrowed) table end,
    # unsigned WRAP epilogue
    s3, j3, c3, e3 = 2, 3, 3, 24
    g3 = ints(0, s2 + 1, (s3, j3))
    g3[1, 0] = s2
    st3 = PackedStage(
        "lut", g3, s2, ints(-9, 9, (s3, c3)).astype(ed),
        [EpiOp("REQUANT", "WRAP", requant((s3, c3), 5, 12, -3, 0, signed=0,
                                          apply=1))],
        in_shift=None, mask=(1 << ints(2, 6, (j3, c3))) - 1,
        table=ints(-big, big, (j3, c3, e3)).astype(big_lane))
    # lut: identity gather, int8 lane, no epilogue
    w3 = s3 * c3
    st4 = PackedStage(
        "lut", np.arange(w3, dtype=np.int64)[None], w3,
        ints(-5, 5, (1, 2)).astype(ed), [], in_shift=None,
        mask=np.full((w3, 2), 15, np.int64),
        table=ints(-128, 128, (w3, 2, 16)).astype(np.int8))
    return PackedStages([st1, st2, st3, st4],
                        out_cols=np.asarray([1, 0], np.int64), n_cols0=n_in)


def phase_synthetic(device):
    import torch
    from repro_torch.kernels.lut_serve_cuda import PackedChain, run_chain, run_chain_plain

    rng = np.random.default_rng(SEED + 3)
    for dtype in (torch.int32, torch.int64):
        packed = synthetic_chain(rng, dtype)
        chain = PackedChain(packed, dtype, device)
        x = torch.as_tensor(rng.integers(-2 ** 10, 2 ** 10, (4099, packed.n_cols0)),
                            device=device).to(dtype)
        got = run_chain(chain, x)
        torch.cuda.synchronize()
        want = run_chain_plain(chain, x)
        check(torch.equal(got, want), f"B4 != plain on the synthetic {dtype} chain")
        lanes = sorted({str(st.table.dtype) for st in packed.stages
                        if st.table is not None})
        print(f"[synthetic] {dtype} compute, lanes {lanes}, B=4099: "
              f"{len(packed.stages)} stages (lut+sum, zero column, in-shifts, "
              f"CMUL, SAT/WRAP epilogues) bit-exact vs the plain chain")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # reference precision: no float32 matmul or convolution rounds via TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import ops

    device = torch.device("cuda:0")
    report = {}
    paths = {"serve": ("lut_dense", "lut_serve"),
             "train": ("fake_quant", "lut_dense", "lut_dense_bwd", "lut_serve")}
    launches = {}
    try:
        phase_device()
        phase_b1(device, report)
        phase_b2(device, report)
        phase_b3(device, report)
        ops.reset_launch_counts()                      # path 1: serve
        prog = phase_slice_float(device)
        chain, xs, packed, b4_err = phase_slice_serve(device, prog)
        launches["serve"] = ops.launch_counts()
        train_state = phase_train(device)
        ops.reset_launch_counts()                      # path 2: train, then serve
        train = phase_train_run(device, *train_state)
        launches["train"] = ops.launch_counts()
        for path, names in paths.items():
            check(all(launches[path][n] > 0 for n in names),
                  f"the {path} path skipped a kernel: launches {launches[path]}")
            print(f"[main-path] {path}: kernel launches {launches[path]}")
        time_b4(chain, xs, packed, b4_err, report)
        phase_synthetic(device)
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    meta = {
        "fake_quant": ("src/repro_torch/csrc/fake_quant.cu",
                       "src/repro/kernels/fake_quant.py:40"),
        "lut_dense": ("src/repro_torch/csrc/lut_dense.cu",
                      "src/repro/kernels/lut_dense.py:86"),
        "lut_dense_bwd": ("src/repro_torch/csrc/lut_dense_bwd.cu",
                          "src/repro/kernels/lut_dense_bwd.py:131"),
        "lut_serve": ("src/repro_torch/csrc/lut_serve.cu",
                      "src/repro/kernels/lut_serve_pallas.py:362"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(launches[p][name] for p in paths), **report[name]}
               for name, (src, rep) in meta.items()]
    print(f"[train] summary: {train['ms_step']:.4f} device ms/step, "
          f"{train['host_ms_step']:.4f} host ms/step, {train['steps_per_s']:.2f} "
          f"steps/s at B={JSC_BATCH}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
