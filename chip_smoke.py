#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA H100 (sm_90).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the path from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once), then runs these phases, each printing a
line:

1. device: the card's name and power limit (``nvidia-smi``) and the build;
2. kernel B2 (eval LUT-Dense forward) against its plain version at the
   JSC-HLF layer shapes 16->20 and 20->5, H=8, B=16600: code flips counted
   and bounded, both timed with CUDA events;
3. the slice, float: the 16,20,5 JSC-HLF stack from a seeded generator; its
   eval forward must equal ``DaisProgram.run_float`` of its own lowering
   exactly, and the fused forward (kernel B2) may differ from it only by a
   bounded count of output-grid flips;
4. the slice, serve: ``build(prog, EngineSpec(engine="pallas",
   require="pallas", verify="full"))`` behind the bit-exact gate, then 8
   request batches each of 1024 and 16600 random in-range codes; each must
   match the plain chain bit for bit and launch kernel B4 exactly once;
5. a seeded synthetic packed chain covering what JSC-HLF does not (sum
   stages, non-identity gathers with the zero column, in-shifts, CMUL and
   WRAP epilogues, int8/int16/int32/int64 lanes, int32 and int64 compute),
   kernel B4 against its plain version bit for bit;
6. the ``kernels`` JSON line, then the result line.

The launch counters are zeroed just before phase 3 and read after phase 4:
the main path must have launched every kernel.  Float32 matmuls and
convolutions run without TF32.  Any failure exits non-zero with no result
line; so does a machine without a CUDA device.
"""

from __future__ import annotations

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
# published H100 SXM peaks: HBM3 bandwidth and dense FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


class SmokeError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
                           "bound_by": b_by}


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


def phase_slice_serve(device, prog):
    import torch
    from repro_torch.core.analysis import analyze_ranges
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import (compose_fused_stages,
                                               input_code_bounds)
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, pack_stages,
                                                    run_chain_plain)
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
    stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    check(stages is not None, why)
    packed = pack_stages(stages, engine.dtype)
    chain = PackedChain(packed, engine.dtype, device)
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
                           "bound_ms": b_ms, "bound_by": b_by}


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
    try:
        phase_device()
        phase_b2(device, report)
        ops.reset_launch_counts()                      # the main path
        prog = phase_slice_float(device)
        chain, xs, packed, b4_err = phase_slice_serve(device, prog)
        launches = ops.launch_counts()
        check(all(n > 0 for n in launches.values()),
              f"the main path skipped a kernel: launches {launches}")
        print(f"[main-path] kernel launches: {launches}")
        time_b4(chain, xs, packed, b4_err, report)
        phase_synthetic(device)
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    meta = {
        "lut_dense": ("src/repro_torch/csrc/lut_dense.cu",
                      "src/repro/kernels/lut_dense.py:86"),
        "lut_serve": ("src/repro_torch/csrc/lut_serve.cu",
                      "src/repro/kernels/lut_serve_pallas.py:362"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **report[name], "library_ms": None}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
