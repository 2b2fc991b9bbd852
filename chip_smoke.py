#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA H100 (sm_90).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all at once), then runs these phases, each printing a
line:

1. device: the card's name and power limit (``nvidia-smi``) and the build;
2. kernel B1 (fake-quant) against its plain version on the card, bit for
   bit, through ``FakeQuant``'s forward, in every width mode and layout:
   the train path's two calls (WRAP on the expand view of a (16600, 16)
   input to (16600, 16, 20), SAT on a contiguous (16600, 16, 20), widths
   (16, 20)), odd sizes, expand views, a copied stride-0 middle axis, and
   edge values and widths (inf, NaN, signed zeros, subnormals, codes at
   the integer-wrap guard, |f| at 126 and 127); then timed with a cold L2
   beside its bounds, its plain version and
   ``torch.fake_quantize_per_tensor_affine``;
3. kernel B2 (LUT-Dense forward) against its plain version, bit for bit
   (any NaN matching any NaN) and in two launches: at the JSC-HLF layer
   shapes 16->20 and 20->5, H=8, B=16600, with a CUDA-graph replay and one
   device kernel a call, both timed with CUDA events beside the bound and
   the issue floor of its SASS; then one cell at a time at the edge widths
   f = +-127, i = -127 and dead cells, x with NaN, +-inf and codes past the
   WRAP guard, H in 1, 3, 8, 16, 17 and B in 1, 31, 4099 by C_out in 1, 33;
   no register spills at H = 8 (ptxas);
4. kernel B3 (recompute backward) against its plain version at the same
   shapes with pruned cells, and one cell at a time at the edge widths f =
   +-127, i = -127, within ``B3_REL``; two launches bitwise equal; one
   device kernel a call (profiler); no register spills at H = 8 (ptxas);
   then B3 past its unrolled instantiations (H = 17, 24, 32 at 20->5, B =
   16600: its generic kernel) within ``B3_REL``, a graph replay at H = 24,
   and one fused train step of a JSC-HLF stack at H = 24 against the plain
   step;
5. the serve slice, float: the 16,20,5 JSC-HLF stack from a seeded
   generator; its eval forward must equal ``DaisProgram.run_float`` of its
   own lowering exactly, and the fused forward (kernel B2) may differ from
   it only by a bounded count of output-grid flips;
6. the serve slice: ``build(prog, EngineSpec(engine="pallas",
   require="pallas", verify="full"))`` behind the bit-exact gate, then 8
   request batches each of 1024 and 16600 random in-range codes; each must
   match the plain chain bit for bit and launch kernel B4 exactly once;
7. kernel B4 on the served JSC-HLF chain: bit for bit equal to its plain
   version at B in 1, 31, 129, 1024, 4099, 16600, 66400, two launches alike,
   a CUDA-graph replay equal to an eager call, one device kernel a call, its
   launch plan; then timed at B = 16600 and 1024 beside its bound and plain
   version;
8. the train slice: ``make_lut_train_step`` with ``lut_use_fused=True`` on
   JSC-HLF data for ``TRAIN_STEPS`` steps at B=16600, each launching B1
   twice, B2 once and B3 once; step 1 held against the same step through
   the plain versions (on the CPU, where the wrappers take them); the Adam
   step counter on the card, and beta and lr from it against the CPU's, in
   ulps; a finite, falling loss; then the trained model evaluated, lowered (eval forward ==
   ``run_float`` exactly) and served through B4 behind the gate;
9. the chunked loop (``train/loop.py``) on the same train slice: the
   per-step loop, ``run_chunked`` with eager chunks of 8 and with CUDA-graph
   chunks of 8 and of 40 (a boundary at step 100, so k in {8, 4} and {40,
   20}, batches built on the host by ``get_batch`` and staged by the
   prefetcher) from one start, bit for bit equal in parameters, Adam state,
   BN stats and every step's loss/CE/EBOPs, each chunk launching B1 x2, B2
   and B3 once per step (a replay counting what its capture recorded); a
   graph run saved by ``CheckpointStore`` at step 100 and stopped at 130,
   restored into fresh layers and run 100-200, bit for bit equal to the
   straight run; the graph-trained model lowered, gated and served through
   B4; then the modes timed in three interleaved rounds (medians and
   ranges of ms/step, host ms/step, steps/s, capture time and peak memory
   per k) and profiled once each (device busy and idle share, device
   kernels per step; a replayed step runs B1 twice, B2 and B3 once);
10. the PID hybrid (``models/pid.py``, ``examples/pid_hybrid.py``) at its
   own widths (HGQ conv front 20 -> 8, LUT-Conv 8 -> 8 and 8 -> 4 kernel 3
   SAME, LUT head 4 -> 1, hidden 8) on ``cepc_waveform``'s own 3000-sample
   waveforms: step 1 held against the same step through the plain versions
   (CPU); ``PID_STEPS`` steps of the example's settings (B = 128, Adam 2e-3
   with cosine restarts, fixed beta 1e-7), each launching B1 eight times, a
   finite and falling MSE, one profile window; test separation power beside
   the truth-count reference; then the trained hybrid lowered at contexts of
   100 and 3000 samples (the eval forward with the front's bias on the
   program's grid equal to ``run_float``), gated
   and served through B4 (B = 1024 and 16600 at 100, 1024 at 3000), every
   batch equal to the plain chain in one launch; off the path: B1 at the
   pid shapes bit for bit and timed, one step with the LUT layers on the
   fused pair (B2, B3) against the plain step, B4 on the pid chains with a
   graph replay and timed beside its bound;
11. the generic op-group runner and the IR tooling, on the models phases 8
   and 10 trained: the JSC-HLF program on ``engine="groups"`` bit for bit
   equal to ``DaisProgram.run`` and to the B4 engine on 8 batches each of
   1024 and 16600 random codes, with no B4 launch; the pid hybrid at one
   window (ctx 20, ROADMAP C4) built with ``engine="pallas"``, warned down
   to the generic path, gated and served (8 batches of 1024), and
   ``require="fused"`` raising; then, on the JSC program and the pid
   program at ctx 100: dead-cell elimination (``build(optimize=True)``,
   equal to ``lower(optimize=True)``) served through B4 behind the gate
   against the unoptimized oracle, ``narrow=False`` through B4 against
   ``narrow=True``, one B4 launch a batch and bit for bit equal to the
   unoptimized engine; the three-way RTL attestation of the DCE'd program
   (RTL simulation == unoptimized interpreter == the B4 engine on the card;
   sha256 and wires printed) and the lint report (line counts).  The pid
   program at ctx 3000 (201,001 instructions) is not simulated as RTL: the
   numpy simulator would spend minutes of host time there and no device
   time.  Then every engine of the phase timed: device busy ms a batch and
   device kernels a call from a profiler trace, the CUDA-event span and the
   host ms a batch: the generic runner's first card numbers, written down,
   not tuned;
12. the serving stack (``serve/``) on the models phases 8 and 10 trained,
   the JSC-HLF program and the pid hybrid at ctx 100: each saved as a bundle
   (``save_artifact``), cold-started from it on the card
   (``build(path, EngineSpec(engine="pallas", require="pallas"))``, with
   ``verify="cached"`` and ``"full"``; the content hash the one saved; the
   cold start printed beside the fresh build's compose, pack, compile and
   gate times) and a copy with one table byte flipped refused; B4 from each
   bundle's stored packed payload at every bucket 1..64 bit for bit its
   plain version; ``compare_under_load`` (engine vs interpreter behind one
   ``MicroBatcher``, every response bit-exact) for JSC at a burst and at
   2000 req/s (1024 requests, ``max_batch=64``, ``max_delay_ms=2``) and for
   pid at a burst (256 requests); ``serve()`` of both bundles on a
   2-replica tier with stealing, 1024 interleaved requests each held
   against its own model's ``DaisProgram.run``, "jsc" hot-swapped for its
   DCE'd engine mid-load; B4's launches equal, exactly, the gates' and the
   buckets' launches plus the batches and warm-ups the scheduler's and the
   tier's stats report; then B4 timed at every bucket and one request
   batch's host time split into padding, ``engine.run`` and ``.cpu()``;
13. seeded packed chains covering what JSC-HLF does not, kernel B4 against
   its plain version bit for bit in int32 and int64 compute: the synthetic
   chain (sum stages, non-identity gathers with the zero column, in-shifts,
   CMUL and WRAP epilogues, int8/int16/int32/int64 lanes), the wide chain
   (constants and a stage's tables in global memory, tiles of fewer than
   32 rows) and a 16->64->5 stack served through the gate, whose first
   stage's tables are read from global memory and second stage's staged in
   shared memory in one launch;
14. the ``kernels`` JSON line, then the result line.

``python3 chip_smoke.py --b1-timing``, ``--b2-timing``, ``--b3-timing`` and
``--b4-timing`` print only kernel B1's, B2's, B3's or B4's timings (and B2's,
B3's or B4's registers, B2's and B3's SASS, B4's launch plan), and
``--loop-timing`` only the chunked loop's timings and profiles, with no
result line, to compare two trees in one call.

The launch counters are zeroed just before each path (phases 5-6, phase 8
after its step-1 comparison, phase 9 before its timings, and phase 10 after
its step-1 comparison and before its off-path checks, phases 11 and 12
before the phase) and read just after it (phases 11 and 12 at their end,
before their timings): each path must have launched each of its kernels, in
phase 11 every generic-path batch none, and in phase 12 B4 exactly as many
times as the phase's gates, buckets, batches and warm-ups add up to.  Float32 matmuls and convolutions run without
TF32.  Any failure exits non-zero with no result line; so does a machine
without a CUDA device.
"""

from __future__ import annotations

import copy
import json
import os
import re
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
# ~2 ms of device clock: longer than the host takes to enqueue 10 calls
HOST_BUSY_CYCLES = 4_000_000
# train steps inside the torch.profiler window
PROFILE_STEPS = (100, 105)
# more than the H100's 50 MB L2: B1's cold-cache timing flushes this much
L2_FLUSH_BYTES = 64 << 20
# published H100 SXM peaks: HBM3 bandwidth and dense FP32 rate; its SMs and
# boost clock (for an instruction-count floor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
H100_SMS = 132
H100_BOOST_HZ = 1.98e9


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


# B1 edge widths (f, i): both sides of the x * 2^f shortcut (|f| <= 126) and
# of the integer-wrap guard (total width w <= 24, f >= -103, |i| <= 126)
B1_EDGE_WIDTHS = ((-127, 127), (-126, 126), (-104, 110), (-103, 110), (-8, 9),
                  (0, 3), (4, 2), (4, 19), (4, 20), (4, 21), (12, 11), (12, 12),
                  (125, -120), (126, -120), (127, -121), (3, 126), (3, 127))


def b1_edge_values(widths, signed):
    """x of shape (V, len(widths)): per column, special values (+-inf, NaN,
    +-0, subnormals) and codes c = x * 2^f at and past the wrap guard's
    edges (2^23, 2^24 - 2^(w-1), 2^24), each also as a half-grid tie."""
    cols = []
    for f, i in widths:
        w = f + i + (1 if signed else 0)
        edges = [2.0 ** 23, 2.0 ** 24, 2.0 ** 24 - 2.0 ** (min(max(w, 1), 60) - 1),
                 2.0 ** (min(max(w, 1), 60) - 1), 2.0 ** min(max(w, 1), 60)]
        codes = [e + d for e in edges for d in (-1.5, -1, -0.5, 0, 0.5, 1, 1.5)]
        codes = codes + [-c for c in codes] + [0.5, -0.5, 1.5, 2.5, 3.0, -7.5]
        with np.errstate(over="ignore", under="ignore"):
            vals = [np.float32(c * 2.0 ** -f) for c in codes]
        vals += [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -1e-40, 1.4e-45,
                 -1.4e-45, 1.17549435e-38, 3.4e38, -3.4e38]
        cols.append(np.asarray(vals, np.float32))
    return np.stack(cols, -1)


def b1_cases(rng, device):
    """B1 inputs in every width mode and layout: (label, x, f, i, signed,
    overflow).

    The train path's two quantizers first: WRAP on the expand view of a
    (16600, 16) input to (16600, 16, 20) and SAT on a contiguous (16600, 16,
    20), both with per-cell widths (16, 20); the same WRAP on a contiguous
    x.  Then per-tensor, per-channel, per-element and trailing-broadcast
    widths at odd sizes (a ragged end past the last full period),
    unsigned, pruned widths, an x that is not 16-byte aligned, expand views
    of other periods, an x with a stride-0 axis that is not the last (copied
    by ``core.quant._fq_forward``), and the edge values and widths of
    ``b1_edge_values`` in all four modes."""
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
    f, i = widths(path[1:], True)
    src = values(path[:2], f[:, 0], i[:, 0])
    cases.append(("path WRAP in (expand view)", src[:, :, None].expand(path), f, i,
                  True, "WRAP"))
    for label, shape, wshape, signed, overflow in (
            ("path WRAP in (contiguous)", path, path[1:], True, "WRAP"),
            ("path SAT out", path, path[1:], True, "SAT"),
            ("tensor", (4099, 7, 13), (), True, "SAT"),
            ("tensor unsigned", (4099, 7, 13), (), False, "WRAP"),
            ("channel", (4099, 7, 13), (13,), True, "WRAP"),
            ("channel unsigned", (4099, 7, 13), (13,), False, "SAT"),
            ("element", (333, 7, 13), (333, 7, 13), True, "SAT"),
            ("element unsigned", (333, 7, 13), (333, 7, 13), False, "WRAP"),
            ("element, long", (4099, 7, 13), (4099, 7, 13), True, "WRAP"),
            ("trailing", (4099, 7, 13), (7, 13), False, "SAT"),
            ("trailing lead-1", (4099, 7, 13), (1, 7, 13), True, "WRAP")):
        f, i = widths(wshape, signed)
        cases.append((label, values(shape, f, i), f, i, signed, overflow))
    f, i = widths((13,), True)
    four, three = (torch.tensor(v, device=device) for v in (4.0, 3.0))
    flat = values((4099 * 13 + 1,), four, three)
    cases.append(("unaligned x", flat[1:].view(4099, 13), f, i, True, "SAT"))
    src = values((JSC_BATCH, JSC_DIMS[1]), four, three)
    f, i = widths(JSC_DIMS[1:], True)
    cases.append(("expand view 20->5", src[:, :, None].expand(JSC_BATCH, *JSC_DIMS[1:]),
                  f, i, True, "WRAP"))
    cases.append(("expand view, per-tensor unsigned", src[:, :, None].expand(
        JSC_BATCH, JSC_DIMS[1], 7), four, three, False, "SAT"))
    src = values((4099, 13), four, three)
    f, i = widths((7, 13), True)
    cases.append(("stride-0 middle axis (copied)", src[:, None, :].expand(4099, 7, 13),
                  f, i, True, "WRAP"))
    for signed in (True, False):
        pairs = np.asarray(B1_EDGE_WIDTHS, np.float32)
        x = torch.as_tensor(b1_edge_values(B1_EDGE_WIDTHS, signed), device=device)
        x = x.repeat(37, 1)[:-1]                  # ragged against the period
        f, i = (torch.as_tensor(pairs[:, k].copy(), device=device) for k in (0, 1))
        for overflow in ("SAT", "WRAP"):
            cases.append((f"edge values and widths, "
                          f"{'signed' if signed else 'unsigned'} {overflow}", x, f, i,
                          signed, overflow))
    return cases


def b1_check_cases(device):
    """Every case of ``b1_cases`` through ``core.quant._fq_forward`` (the
    forward of ``FakeQuant``) against the plain version, bit for bit; one B1
    launch each."""
    for case in b1_cases(np.random.default_rng(SEED + 4), device):
        b1_check(*case)


def b1_check(label, x, f, i, signed, overflow):
    """One B1 case through ``core.quant._fq_forward`` against the plain
    version, bit for bit, in one launch."""
    import torch
    from repro_torch.core.quant import _fq_forward
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fake_quant_ref

    before = ops.launch_counts()["fake_quant"]
    got = _fq_forward(x, f, i, signed, overflow)
    torch.cuda.synchronize()
    check(ops.launch_counts()["fake_quant"] == before + 1,
          f"B1 {label}: not one launch")
    want = fake_quant_ref(x, f, i, signed, overflow)
    bad = got.view(torch.int32) != want.view(torch.int32)
    n_bits = int(bad.sum())
    if n_bits:
        at = bad.nonzero()[:6].tolist()
        fb, ib = (torch.broadcast_to(w, x.shape) for w in (f, i))
        for k in at:
            k = tuple(k)
            print(f"[B1] {label} differs at {k}: x {float(x[k])!r}, f "
                  f"{float(fb[k])}, i {float(ib[k])}: kernel "
                  f"{int(got.view(torch.int32)[k]):#010x}, plain "
                  f"{int(want.view(torch.int32)[k]):#010x}")
    check(got.shape == x.shape and got.is_contiguous() and n_bits == 0,
          f"B1 {label}: {n_bits} bit patterns differ from the plain version")
    print(f"[B1] {label}: x {tuple(x.shape)} strides {x.stride()}, widths "
          f"{tuple(f.shape)}, {'signed' if signed else 'unsigned'} {overflow}: "
          f"identical to the plain version, bit for bit ({x.numel()} values)")


def cuda_ms_cold(fn, pool, iters: int = 24) -> float:
    """Mean device time of ``fn(pool[k % len(pool)])`` with a cold L2.

    The inputs rotate over ``pool`` (together larger than the L2) and every
    output of the timed loop is kept alive, so each launch writes memory
    that no recent launch touched; the L2 is flushed before the loop.  A
    first pass with the same allocations warms the allocator, so the timed
    pass reuses its blocks without a cudaMalloc.  The stream sleeps first,
    as in :func:`cuda_ms`."""
    import torch

    outs = [fn(pool[k % len(pool)]) for k in range(iters)]
    torch.cuda.synchronize()
    del outs
    # overwrite more than the 50 MB L2 with an unrelated buffer
    torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=pool[0].device).zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    outs = [fn(pool[k % len(pool)]) for k in range(iters)]
    end.record()
    torch.cuda.synchronize()
    del outs
    return start.elapsed_time(end) / iters


def b1_timings(device, fq, rng, tag=""):
    """B1 timed with a cold L2 at the train path's shapes (``fq`` is a
    ``fake_quant_fused``; a wrapper without expand-view support, as before
    the redesign, gets no direct expand-view time).  Prints each time beside
    its bound and returns them by name."""
    import torch
    from repro_torch.kernels.ref import fake_quant_ref

    c_in, c_out = JSC_DIMS[0], JSC_DIMS[1]
    shape = (JSC_BATCH, c_in, c_out)
    n = JSC_BATCH * c_in * c_out
    f = torch.as_tensor(rng.integers(-3, 7, (c_in, c_out)), dtype=torch.float32,
                        device=device)
    i = torch.as_tensor(rng.integers(-2, 5, (c_in, c_out)), dtype=torch.float32,
                        device=device)
    n_pool = max(2, -(-3 * L2_FLUSH_BYTES // (8 * n)))
    pool = [torch.as_tensor(rng.normal(0, 4, shape), dtype=torch.float32, device=device)
            for _ in range(n_pool)]
    src_pool = [torch.as_tensor(rng.normal(0, 4, shape[:2]), dtype=torch.float32,
                                device=device)
                for _ in range(max(2, -(-3 * L2_FLUSH_BYTES // (4 * JSC_BATCH * c_in))))]
    expand = lambda s: s[:, :, None].expand(shape)
    fs, is_ = 4, 3
    f1, i1 = (torch.tensor(float(v), device=device) for v in (fs, is_))
    t = {}
    t["wrap_cell"] = cuda_ms_cold(lambda x: fq(x, f, i, signed=True, overflow="WRAP"), pool)
    t["plain_wrap_cell"] = cuda_ms_cold(lambda x: fake_quant_ref(x, f, i, True, "WRAP"),
                                        pool, iters=8)
    t["sat_tensor"] = cuda_ms_cold(lambda x: fq(x, f1, i1, signed=True, overflow="SAT"),
                                   pool)
    t["library_sat_tensor"] = cuda_ms_cold(
        lambda x: torch.fake_quantize_per_tensor_affine(
            x, 2.0 ** -fs, 0, -2 ** (is_ + fs), 2 ** (is_ + fs) - 1), pool)
    t["plain_sat_tensor"] = cuda_ms_cold(lambda x: fake_quant_ref(x, f1, i1, True, "SAT"),
                                         pool, iters=8)
    t["sat_cell"] = cuda_ms_cold(lambda x: fq(x, f, i, signed=True, overflow="SAT"), pool)
    # every width pruned: the kernel's memory pattern with no arithmetic
    fd, id_ = torch.full_like(f, -5.0), torch.zeros_like(i)
    t["pruned"] = cuda_ms_cold(lambda x: fq(x, fd, id_, signed=True, overflow="WRAP"), pool)
    t["copy_then_wrap"] = cuda_ms_cold(
        lambda s: fq(expand(s).contiguous(), f, i, signed=True, overflow="WRAP"), src_pool)
    if fq.__module__ and hasattr(sys.modules[fq.__module__], "x_layout"):
        t["expand_wrap"] = cuda_ms_cold(
            lambda s: fq(expand(s), f, i, signed=True, overflow="WRAP"), src_pool)
        t["expand_pruned"] = cuda_ms_cold(
            lambda s: fq(expand(s), fd, id_, signed=True, overflow="WRAP"), src_pool)
    t["plain_expand_wrap"] = cuda_ms_cold(
        lambda s: fake_quant_ref(expand(s), f, i, True, "WRAP"), src_pool, iters=8)
    # same function, same inputs: B1 per-tensor SAT against the library call
    x = pool[0]
    mine = fq(x, f1, i1, signed=True, overflow="SAT")
    n_lib = int((torch.fake_quantize_per_tensor_affine(
        x, 2.0 ** -fs, 0, -2 ** (is_ + fs), 2 ** (is_ + fs) - 1) != mine).sum())
    w_bytes = 8 * c_in * c_out
    t["bound_contiguous"], by = bound(8 * n + w_bytes, 10 * n)
    t["bound_expand"], by_e = bound(4 * n + 4 * JSC_BATCH * c_in + w_bytes, 10 * n)
    t["bound_by"], t["library_differs"] = by, n_lib
    print(f"[B1{tag}] cold L2 (inputs rotate over {n_pool} x {4 * n / 1e6:.1f} MB, "
          f"outputs fresh), x {shape}, widths ({c_in}, {c_out}) unless per-tensor:")
    print(f"[B1{tag}]   contiguous, per-cell WRAP: kernel {t['wrap_cell']:.5f} ms, "
          f"plain {t['plain_wrap_cell']:.5f} ms, bound {t['bound_contiguous']:.5f} ms "
          f"({by}); per-cell SAT kernel {t['sat_cell']:.5f} ms; all widths pruned "
          f"(no arithmetic) {t['pruned']:.5f} ms")
    print(f"[B1{tag}]   contiguous, per-tensor signed SAT (f={fs}, i={is_}): kernel "
          f"{t['sat_tensor']:.5f} ms, torch.fake_quantize_per_tensor_affine "
          f"{t['library_sat_tensor']:.5f} ms (differs in {n_lib} values), plain "
          f"{t['plain_sat_tensor']:.5f} ms, bound {t['bound_contiguous']:.5f} ms")
    print(f"[B1{tag}]   the path's input, expand view of {shape[:2]}, per-cell WRAP: "
          + (f"kernel on the view {t['expand_wrap']:.5f} ms (all widths pruned "
             f"{t['expand_pruned']:.5f} ms), " if "expand_wrap" in t
             else "kernel on the view: not supported, ")
          + f".contiguous() then kernel {t['copy_then_wrap']:.5f} ms, plain "
          f"{t['plain_expand_wrap']:.5f} ms, bound {t['bound_expand']:.5f} ms ({by_e})")
    return t


def phase_b1(device, report):
    from repro_torch.kernels.fake_quant import fake_quant_fused

    b1_check_cases(device)
    t = b1_timings(device, fake_quant_fused, np.random.default_rng(SEED + 6))
    check(t["library_differs"] == 0,
          "B1 per-tensor SAT differs from torch.fake_quantize_per_tensor_affine")
    report["fake_quant"] = {
        "max_abs_err": 0.0, "ms": t["wrap_cell"], "plain_ms": t["plain_wrap_cell"],
        "bound_ms": t["bound_contiguous"], "bound_by": t["bound_by"],
        "library_ms": t["library_sat_tensor"],
        "sat_tensor_ms": t["sat_tensor"], "expand_ms": t["expand_wrap"],
        "expand_bound_ms": t["bound_expand"], "copy_then_ms": t["copy_then_wrap"]}


# B2's instantiation at the path's H, by substrings of its mangled name
B2_KERNEL = ("lut_dense_forward_kernel", f"ILi{HIDDEN}E")


def b2_kernel():
    """``B2_KERNEL``, or its name alone in a build where B2 is no template."""
    from repro_torch.kernels import build as kbuild

    log = kbuild.build_log("lut_dense")
    return B2_KERNEL if all(k in log for k in B2_KERNEL) else B2_KERNEL[:1]


def same_bits(a, b) -> bool:
    """Identical float32 bit patterns, any NaN matching any NaN."""
    import torch

    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return torch.equal(a.masked_fill(nan, 0).view(torch.int32),
                       b.masked_fill(nan, 0).view(torch.int32))


def b2_random_args(rng, batch, c_in, c_out, hidden, device):
    """Seeded B2 inputs: x ~ N(0, 3) and weights as LUTDense draws them,
    integer widths with some cells dead on either side."""
    import torch

    w = [rng.normal(0, s, (c_in, hidden, c_out)) for s in (1.0, 0.5, (hidden * c_in) ** -0.5)]
    cells = [rng.normal(0, 0.2, (c_in, c_out))]
    cells += [rng.integers(lo, hi, (c_in, c_out)) for lo, hi in ((-2, 8), (-2, 5), (-1, 9), (-2, 4))]
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.as_tensor(rng.normal(0, 3, (batch, c_in)), **f32)
    return x, [torch.as_tensor(a, **f32) for a in w + cells]


# B2 edge cells, one at a time (C_in = C_out = 1): input widths as B3's
# (B3_EDGE_IN), a dead one (f + i + 1 <= 0) and an ordinary one whose codes
# vary over the rows; output widths as B3's (B3_EDGE_OUT) and a dead one,
# with w_out and b_out scaled so that y spans the output grid's codes
B2_MORE_IN = ((-1, -1, (-4.0, 4.0), 1.0, 1.0), (4, 3, (-6.0, 6.0), 1.0, 1.0))
B2_EDGE_OUT = {(127, -127): 2.0 ** -127, (-127, 127): 2.0 ** 124,
               (130, -127): 2.0 ** -128, (0, -1): 1.0}


def b2_special_x(rng, batch, c_in, f_in):
    """x of shape (batch, c_in): normal draws with NaN, +-inf, +-0,
    subnormals, huge values and codes x * 2^f_in past the WRAP guard
    (|code| >= 2^24) and at half-code ties, in every column."""
    x = rng.normal(0, 3, (batch, c_in)).astype(np.float32)
    scale = np.float32(2.0) ** -np.asarray(f_in, np.float32).min(axis=1)      # per column
    special = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 3.4e38])
    guard = np.float32([2 ** 24, -2 ** 24, 2 ** 24 + 2, 2 ** 30, 2 ** 23 + 0.5, 2.5, -0.5])
    rows = rng.choice(batch, (len(special) + len(guard), c_in), replace=False)
    for j in range(c_in):
        r = rows[:, j]
        x[r[:len(special)], j] = special
        x[r[len(special):], j] = guard * scale[j]
    return x


def b2_cases(rng, device):
    """Every B2 case of the card checks besides the path shapes: (label, x,
    args).  Edge widths one cell at a time; x with NaN, +-inf and codes past
    the WRAP guard; H in {1, 3, 8, 16, 17} (17 is the generic
    instantiation); B in {1, 31, 4099} by C_out in {1, 33}."""
    import torch

    f32 = dict(dtype=torch.float32, device=device)
    cases = []
    for f_in, i_in, (lo, hi), x_scale, _g in B3_EDGE_IN + B2_MORE_IN:
        for (f_out, i_out), y_scale in B2_EDGE_OUT.items():
            w = [rng.normal(0, s, (1, HIDDEN, 1)) for s in (1.0, 0.5, y_scale)]
            cells = [rng.normal(0, 0.2 * y_scale, (1, 1))] + [
                np.full((1, 1), v) for v in (f_in, i_in, f_out, i_out)]
            x = torch.as_tensor(rng.uniform(lo, hi, (4099, 1)) * x_scale, **f32)
            cases.append((f"cell f_in {f_in} i_in {i_in}, f_out {f_out} i_out {i_out}", x,
                          [torch.as_tensor(a, **f32) for a in w + cells]))
    for c_in, c_out in ((20, 5), (16, 20)):
        _x, args = b2_random_args(rng, 4099, c_in, c_out, HIDDEN, device)
        x = torch.as_tensor(b2_special_x(rng, 4099, c_in, args[4].cpu().numpy()), **f32)
        cases.append((f"special x {c_in}->{c_out}", x, args))
    for hidden in (1, 3, 8, 16, 17):
        cases.append((f"H={hidden}", *b2_random_args(rng, 999, 5, 7, hidden, device)))
    for batch in (1, 31, 4099):
        for c_out in (1, 33):
            cases.append((f"B={batch} C_out={c_out}",
                          *b2_random_args(rng, batch, 6, c_out, HIDDEN, device)))
    return cases


def b2_check(label, fn, x, args):
    """Kernel B2 (``fn``) twice on the same inputs against its plain
    version: both launches bit for bit equal to it (any NaN matching any
    NaN).  Returns the output."""
    import torch
    from repro_torch.kernels.ref import lut_dense_ref

    got = fn(x, *args)
    again = fn(x, *args)
    torch.cuda.synchronize()
    want = lut_dense_ref(x, *args)
    check(got.shape == want.shape, f"B2 {label}: shape {tuple(got.shape)}")
    check(same_bits(got, again), f"B2 {label}: two launches on the same inputs differ")
    n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    check(same_bits(got, want), f"B2 {label}: {n} outputs differ from the plain version")
    return got


def b2_graph_replay(fn, x, args) -> bool:
    """One B2 call captured in a CUDA graph and replayed three times gives
    the eager call's bits."""
    import torch

    eager = fn(x, *args).clone()            # before capture: the plan is queried
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, *args)
    ok = True
    for _ in range(3):
        out.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        ok = ok and same_bits(out, eager)
    return ok


def b2_path_inputs(device):
    """The JSC-HLF layers (16->20 with BN, 20->5, H=8) from seed SEED + 1,
    each with x of B = 16600 rows: [((ci, co), x, args)]."""
    import torch
    from repro_torch.core.lut_layers import LUTDense

    gen = torch.Generator().manual_seed(SEED + 1)
    out = []
    for k, (ci, co) in enumerate(zip(JSC_DIMS[:-1], JSC_DIMS[1:])):
        layer = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0),
                         device=device, generator=gen)
        x = (torch.randn((JSC_BATCH, ci), generator=gen) * 4.0).to(device)
        out.append(((ci, co), x, layer.kernel_args()))
    return out


def b2_bound(x, args, out_numel):
    n_bytes = 4 * (x.numel() + out_numel + sum(a.numel() for a in args))
    batch, ci = x.shape
    # per cell: WRAP quant (~8 ops) + SAT quant (~6); per hidden unit: mul,
    # add, tanh (counted as one), mul, add
    n_ops = batch * ci * args[0].shape[2] * (5 * args[0].shape[1] + 14)
    return bound(n_bytes, n_ops)


def host_us(fn, busy: bool):
    """Host us a call of ``fn``, enqueue only: the median and mean of 1000
    calls timed one by one, the stream synchronized (untimed) every 10 calls
    so that a full launch queue never holds the host.  With ``busy`` the
    stream is first put to sleep for ``HOST_BUSY_CYCLES``, so the 10 calls
    queue behind work on the device and their cost does not depend on how
    fast the device runs them (a launch onto an idle device costs the host
    more); without, the device idles between calls once it outruns the host,
    as in the host-bound train step."""
    import torch

    host = []
    for k in range(1010):
        if k % 10 == 0:
            torch.cuda.synchronize()
            if busy:
                torch.cuda._sleep(HOST_BUSY_CYCLES)
        t0 = time.perf_counter()
        fn()
        if k >= 10:
            host.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(host)), float(np.mean(host))


def b2_timings(fn, device, tag="", per_row=None):
    """B2 (``fn``) at the JSC-HLF layer shapes, B = 16600: device ms by CUDA
    events with the host ahead, host us per call enqueue-only with the device
    busy and idle (``host_us``), beside the bound and the issue floor of
    ``per_row`` instructions per (b, j, o)."""
    out = {}
    for (ci, co), x, args in b2_path_inputs(device):
        ms = cuda_ms(lambda: fn(x, *args), iters=50)
        busy = host_us(lambda: fn(x, *args), busy=True)
        idle = host_us(lambda: fn(x, *args), busy=False)
        b_ms, b_by = b2_bound(x, args, JSC_BATCH * co)
        floor = None if per_row is None else issue_floor_ms(JSC_BATCH * ci * co, per_row)
        out[(ci, co)] = (ms, busy, idle, b_ms, b_by, floor)
        print(f"[B2{tag}] {ci}->{co} H={HIDDEN} B={JSC_BATCH}: device {ms:.5f} ms a "
              f"call (CUDA events, host ahead); host {busy[0]:.2f} us a call median, "
              f"{busy[1]:.2f} mean (enqueue only, 1000 calls, device busy), "
              f"{idle[0]:.2f} median, {idle[1]:.2f} mean (device idle between "
              f"calls); bound {b_ms:.5f} ms ({b_by})"
              + ("" if floor is None else f"; issue floor of the j loop {floor:.5f} ms"))
    return out


def phase_b2(device, report):
    import torch
    from repro_torch.kernels.lut_dense import lut_dense_fused
    from repro_torch.kernels.ref import lut_dense_ref

    kern = b2_kernel()
    usage = ptxas_usage("lut_dense", kern)
    print(f"[B2] ptxas, H={HIDDEN}: {usage}")
    check(" 0 bytes spill stores" in usage and " 0 bytes spill loads" in usage,
          f"B2 at H={HIDDEN} spills registers: {usage}")
    sass, per_row = sass_hot_loop("lut_dense", kern, HIDDEN)
    print(f"[B2] SASS, H={HIDDEN}: {sass}")
    rows = {}
    for (ci, co), x, args in b2_path_inputs(device):
        got = b2_check(f"{ci}->{co}", lut_dense_fused, x, args)
        want = lut_dense_ref(x, *args)
        err = float((got - want).abs().max())
        check(got.shape == (JSC_BATCH, co) and bool(torch.isfinite(got).all()),
              f"B2 {ci}->{co}: bad output")
        step = torch.exp2(-args[6].max(dim=0).values)          # finest f_out
        n_flip, max_steps = flips(got, want, step)
        check(n_flip <= B2_FLIP_FRAC * got.numel() and max_steps <= 2.0,
              f"B2 {ci}->{co}: {n_flip} outputs differ (max {max_steps} steps)")
        kernels = device_kernels(lambda: lut_dense_fused(x, *args))
        check(len(kernels) == 1, f"B2 {ci}->{co}: {len(kernels)} device kernels a call")
        check(b2_graph_replay(lut_dense_fused, x, args),
              f"B2 {ci}->{co}: a CUDA-graph replay differs from the eager call")
        ms = cuda_ms(lambda: lut_dense_fused(x, *args), iters=50)
        plain_ms = cuda_ms(lambda: lut_dense_ref(x, *args))
        b_ms, b_by = b2_bound(x, args, got.numel())
        floor = None if per_row is None else issue_floor_ms(JSC_BATCH * ci * co, per_row)
        print(f"[B2] {ci}->{co} H={HIDDEN} B={JSC_BATCH}: {n_flip} of {got.numel()} "
              f"outputs differ from the plain version (bit for bit equal); two "
              f"launches bitwise equal; graph replay equal; {len(kernels)} device "
              f"kernel a call; kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})"
              + ("" if floor is None else f", issue floor of the j loop {floor:.5f} ms"))
        rows[(ci, co)] = (ms, plain_ms, b_ms, b_by, floor, err)
    cases = b2_cases(np.random.default_rng(SEED + 8), device)
    for label, x, args in cases:
        b2_check(label, lut_dense_fused, x, args)
    print(f"[B2] {len(cases)} more cases bit for bit equal to the plain version, two "
          f"launches each bitwise equal: {'; '.join(c[0] for c in cases)}")
    ms, plain_ms, b_ms, b_by, floor, _ = rows[(16, 20)]     # the wider layer
    narrow = rows[(20, 5)]                                   # the train path's layer
    report["lut_dense"] = {"max_abs_err": max(r[5] for r in rows.values()), "ms": ms,
                           "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                           "floor_ms": floor, "ms_20_5": narrow[0],
                           "plain_ms_20_5": narrow[1], "bound_ms_20_5": narrow[2],
                           "floor_ms_20_5": narrow[4], "kernels_per_call": 1}


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


# B3 edge widths, where 2^-f or 2^i leaves exp2's exact range on the card
# (ROADMAP C7, C8).  Input cells (f_in, i_in, x range, g scale): x is drawn
# so that the codes x * 2^f stay few and every gradient finite (at f_in =
# -127 the WRAP span 2^128 is inf, so codes stay in {-1, 0}); output cells
# (f_out, i_out).
B3_EDGE_IN = ((127, -127, (-1.4, 1.4), 2.0 ** -126, 2.0 ** 20),
              (-127, 127, (-1.4, 0.45), 2.0 ** 127, 2.0 ** -20),
              (127, 0, (-1.4, 1.4), 2.0 ** -120, 1.0))
B3_EDGE_OUT = ((127, -127), (-127, 127), (130, -127))


def b3_edge_args(rng, batch, device, hidden=8):
    """One-cell B3 inputs (C_in = C_out = 1) for every pair of an edge input
    and an edge output width, so that each gradient tensor holds one cell
    and the tolerance is relative to that cell's own magnitude: (label, x,
    args, g)."""
    import torch

    cases = []
    for f_in, i_in, (lo, hi), x_scale, g_scale in B3_EDGE_IN:
        for f_out, i_out in B3_EDGE_OUT:
            w = [rng.normal(0, s, (1, hidden, 1)) for s in (1.0, 0.5, 1.0)]
            cells = [rng.normal(0, 0.2, (1, 1))] + [np.full((1, 1), v)
                                                    for v in (f_in, i_in, f_out, i_out)]
            args = [torch.as_tensor(a, dtype=torch.float32, device=device)
                    for a in w + cells]
            x = torch.as_tensor(rng.uniform(lo, hi, (batch, 1)) * x_scale,
                                dtype=torch.float32, device=device)
            g = torch.as_tensor(rng.normal(0, 1, (batch, 1)) * g_scale,
                                dtype=torch.float32, device=device)
            cases.append((f"f_in {f_in} i_in {i_in}, f_out {f_out} i_out {i_out}",
                          x, args, g))
    return cases


# B3's instantiation at the path's H, by substrings of its mangled name
B3_KERNEL = ("lut_dense_bwd_", f"ILi{HIDDEN}E")
B3_NAMES = ("dx", "dw0", "db0", "dw_out", "db_out", "df_in", "df_out", "di_out")


def b3_max_rel_err(got, want):
    """Largest |got - want| over each tensor's largest |want|, by name."""
    return {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(B3_NAMES, got, want)}


def b3_check(label, fn, x, args, g):
    """Kernel B3 (``fn``) twice on the same inputs against its plain version:
    bitwise equal launches, finite, every gradient within ``B3_REL`` of the
    plain one's largest magnitude.  Returns the errors by name."""
    import torch
    from repro_torch.kernels.ref import lut_dense_bwd_ref

    got = fn(x, *args, g)
    again = fn(x, *args, g)
    torch.cuda.synchronize()
    want = lut_dense_bwd_ref(x, *args, g)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, again))
    check(same, f"B3 {label}: two launches on the same inputs differ")
    rel = b3_max_rel_err(got, want)
    worst = max(rel, key=rel.get)
    check(all(bool(torch.isfinite(t).all()) for t in got) and rel[worst] <= B3_REL,
          f"B3 {label}: {worst} off by {rel[worst]:.3g} of its largest "
          f"magnitude (> {B3_REL})")
    rel["max_abs"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
    return rel


PROFILE_TRIES = 5


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs: the "kernel"
    events of a torch.profiler trace of CPU and CUDA activity.  A profile has
    been seen on the H100 to record no device event, several in a row, for a
    call that launched its kernel (PERF.md section 7), so this takes a
    profile that records none again, up to ``PROFILE_TRIES`` of them, and
    then counts the kernel nodes of the call captured in a CUDA graph
    (``graph_kernels``)."""
    for _ in range(PROFILE_TRIES):
        names = [name for name, _dur in profile_kernels(fn)]
        if names:
            return names
    names = graph_kernels(fn)
    print(f"[profile] {PROFILE_TRIES} profiles recorded no kernel; the call captured "
          f"in a CUDA graph holds {len(names)} kernel nodes", file=sys.stderr)
    return names


def profile_kernels(fn) -> list:
    """(name, device µs) of each "kernel" event in a torch.profiler trace of
    CPU and CUDA activity around ``fn()``, read from the exported trace, as
    ``trace_summary`` does.  The profiler takes one warm-up step of ``fn()``
    before the step it records: a profile that starts on the call it traces
    has been seen on the H100 to drop its first kernel events (PERF.md
    section 7).  Empty (with the trace's events by category on stderr) when
    the profile recorded no kernel."""
    import torch
    from repro_torch.kernels import build as kbuild

    path = kbuild.BUILD_DIR / "device_kernels.json"
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [(e["name"], float(e.get("dur", 0.0))) for e in events
               if e.get("cat") == "kernel"]
    if not kernels:
        cats = {}
        for e in events:
            cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        print(f"[profile] no kernel event in a profile; events by category {cats}",
              file=sys.stderr)
    return kernels


def graph_kernels(fn) -> list:
    """Mangled names of the kernel nodes of one call of ``fn`` captured in a
    CUDA graph, read from the graph's DOT dump (``cudaGraphDebugDotPrint``)."""
    import torch
    from repro_torch.kernels import build as kbuild

    path = kbuild.BUILD_DIR / "device_kernels.dot"
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    graph.debug_dump(str(path))
    with open(path) as fh:
        return dot_kernel_names(fh.read())


def dot_kernel_names(dot: str) -> list:
    """The kernel nodes' names in a verbose CUDA graph DOT dump."""
    return re.findall(r"\{KERNEL\s*\|\s*\{ID\s*\|[^|]*\|\s*([^\s\\<}]+)", dot)


def ptxas_usage(name: str, kernel) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of the kernel whose
    mangled name contains every string of ``kernel``, from the last build
    of ``name``."""
    for func, usage in ptxas_entries(name):
        if all(k in func for k in kernel):
            return usage
    return "not in the build log"


def ptxas_entries(name: str):
    """Every kernel's ``-Xptxas -v`` lines (registers, spills, shared
    memory) in the last build of ``name``: (mangled name, usage)."""
    from repro_torch.kernels import build as kbuild

    out, cur = [], None
    for ln in kbuild.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            cur = [ln.split("'")[1] if "'" in ln else ln.strip(), []]
            out.append(cur)
        elif cur is not None and ("spill" in ln or "Used" in ln):
            cur[1].append(ln.split(" : ", 1)[-1].strip())
    return [(f, "; ".join(u)) for f, u in out]


def b3_timings(fn, device, tag="", per_row=None):
    """B3 (``fn``) at the JSC-HLF layer shapes, B = 16600: device ms by CUDA
    events with the host ahead, host us per call enqueue-only (the median
    and mean of 1000 calls timed one by one, the stream synchronized, untimed,
    every 10 calls so that a full launch queue never holds the host)."""
    import torch
    from repro_torch.core.lut_layers import LUTDense

    gen = torch.Generator().manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for k, (ci, co) in enumerate(zip(JSC_DIMS[:-1], JSC_DIMS[1:])):
        layer = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0),
                         device=device, generator=gen)
        x, args, g = b3_args(layer, rng, JSC_BATCH, device)
        ms = cuda_ms(lambda: fn(x, *args, g), iters=50)
        host = []
        for k in range(1010):
            if k % 10 == 0:              # never more than 10 calls queued
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(x, *args, g)
            if k >= 10:
                host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        out[(ci, co)] = (ms, float(np.median(host)), float(np.mean(host)))
        floor = ("" if per_row is None else
                 f"; issue floor of the row loop alone {issue_floor_ms(JSC_BATCH * ci * co, per_row):.5f} ms")
        print(f"[B3{tag}] {ci}->{co} H={HIDDEN} B={JSC_BATCH}: device {ms:.5f} ms a "
              f"call (CUDA events, host ahead); host {np.median(host):.2f} us a call "
              f"median, {np.mean(host):.2f} mean (enqueue only, 1000 calls){floor}")
    return out


def issue_floor_ms(n_rows: int, per_row: float) -> float:
    """The least time ``n_rows`` of ``per_row`` instructions each take at
    one warp instruction a clock on each of an SM's 4 schedulers, all SMs,
    at the published boost clock: an instruction-count floor."""
    return n_rows * per_row / 32 / (4 * H100_SMS * H100_BOOST_HZ) * 1e3


# tanhf's first step, |x| * 2 / ln 2 before MUFU.EX2: one per tanh in SASS
TANH_MARK = "2.8853900432586669922"


def sass_hot_loop(name: str, kernel, hidden: int) -> str:
    """SASS of the kernel whose mangled name contains every string of
    ``kernel`` in the built library ``name`` (``cuobjdump -sass``): its
    instruction count, and the innermost loop that evaluates whole rows of
    tanh (``TANH_MARK``, ``hidden`` of them a (b, j, o); of an unrolled loop
    and its remainder, the one with fewer instructions a row), with its
    instructions per (b, j, o).  The count is static: it includes any code
    in the loop that the common path branches around.  Returns the text
    and that count (None where there is no such loop)."""
    import re
    import shutil

    from repro_torch.kernels import build as kbuild

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found", None
    text = subprocess.run([tool, "-sass", str(kbuild.library_path(name))],
                          capture_output=True, text=True, timeout=300).stdout
    funcs = [f for f in text.split("Function : ")[1:]
             if all(k in f.split("\n", 1)[0] for k in kernel)]
    if not funcs:
        return f"no function matching {kernel}", None
    labels, ins = {}, []
    for ln in funcs[0].splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            labels[m.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    addr = {a: k for k, (a, _) in enumerate(ins)}
    loops = []
    for k, (_, op) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))", op)
        if not m:
            continue
        tgt = addr.get(int(m.group(1), 16)) if m.group(1) else labels.get(m.group(2))
        if tgt is not None and tgt <= k:
            body = [o for _, o in ins[tgt:k + 1]]
            n_tanh = sum(TANH_MARK in o for o in body)
            if n_tanh >= hidden:
                loops.append((tgt, k + 1, n_tanh, sum("SHFL" in o for o in body),
                              sum("MUFU" in o for o in body)))
    # innermost loops only (an unrolled loop's remainder is one too); of
    # those, the fewest instructions a row: the loop the common shape runs
    inner = [lp for lp in loops
             if not any(lp[0] <= q[0] and q[1] <= lp[1] and q != lp for q in loops)]
    if not inner:
        return f"{len(ins)} instructions; no loop evaluates a row of tanh", None
    a, b, n_tanh, n_shfl, n_mufu = min(inner, key=lambda lp: (lp[1] - lp[0]) / lp[2])
    n, rows = b - a, n_tanh / hidden
    return (f"{len(ins)} instructions; innermost loop over rows: {n} instructions "
            f"(static), {n_tanh} tanh = {rows:g} rows of (b, j, o), {n_mufu} MUFU, "
            f"{n_shfl} shuffles: {n / rows:.1f} instructions per (b, j, o)"), n / rows


def phase_b3(device, report):
    import torch
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels.lut_dense import lut_dense_fused
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.kernels.ref import lut_dense_bwd_ref, lut_dense_ref

    usage = ptxas_usage("lut_dense_bwd", B3_KERNEL)
    print(f"[B3] ptxas, H={HIDDEN}: {usage}")
    check(" 0 bytes spill stores" in usage and " 0 bytes spill loads" in usage,
          f"B3 at H={HIDDEN} spills registers: {usage}")
    gen = torch.Generator().manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for k, (ci, co) in enumerate(zip(JSC_DIMS[:-1], JSC_DIMS[1:])):
        layer = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=(k == 0),
                         device=device, generator=gen)
        x, args, g = b3_args(layer, rng, JSC_BATCH, device)
        rel = b3_check(f"{ci}->{co}", lut_dense_bwd_fused, x, args, g)
        worst = max(B3_NAMES, key=rel.get)
        kern = device_kernels(lambda: lut_dense_bwd_fused(x, *args, g))
        check(len(kern) == 1, f"B3 {ci}->{co}: {len(kern)} device kernels a call: {kern}")
        # the forward it recomputes: B2 on the same inputs against its plain version
        n_flip, _ = flips(lut_dense_fused(x, *args), lut_dense_ref(x, *args),
                          torch.exp2(-args[6].max(dim=0).values))
        ms = cuda_ms(lambda: lut_dense_bwd_fused(x, *args, g), iters=50)
        plain_ms = cuda_ms(lambda: lut_dense_bwd_ref(x, *args, g), iters=5, warmup=1)
        n_bytes = 4 * (2 * x.numel() + g.numel() + 2 * sum(a.numel() for a in args[:4])
                       + 2 * sum(a.numel() for a in args[4:]))
        # per (b, j, o): quantizers and surrogates ~30 ops; per hidden unit
        # ~16 (forward mul, add, tanh as one, mul, add; backward 11)
        n_ops = JSC_BATCH * ci * co * (16 * HIDDEN + 30)
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"[B3] {ci}->{co} H={HIDDEN} B={JSC_BATCH}, pruned cells: all eight "
              f"gradients within {B3_REL} of the plain version (worst {worst} "
              f"{rel[worst]:.3g}; max|err| {rel['max_abs']:.3g}); dx off by "
              f"{rel['dx']:.3g}; recomputed forward flips vs plain {n_flip}; two "
              f"launches bitwise equal; {len(kern)} device kernel a call ({kern[0]}); "
              f"kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        rows.append((rel["max_abs"], ms, plain_ms, b_ms, b_by))
    edge = b3_edge_args(np.random.default_rng(SEED + 7), 4099, device)
    worst_edge = 0.0
    for label, x, args, g in edge:
        rel = b3_check(f"edge {label}", lut_dense_bwd_fused, x, args, g)
        worst_edge = max(worst_edge, max(rel[n] for n in B3_NAMES))
    print(f"[B3] edge widths, one cell each at B=4099 ({len(edge)} cases: f_in/i_in "
          f"in {[w[:2] for w in B3_EDGE_IN]}, f_out/i_out in {list(B3_EDGE_OUT)}): all "
          f"eight gradients within {B3_REL} of the plain version (worst "
          f"{worst_edge:.3g}), finite, two launches bitwise equal")
    err, ms, plain_ms, b_ms, b_by = rows[1]           # the path's layer, 20->5
    report["lut_dense_bwd"] = {"max_abs_err": max(r[0] for r in rows), "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "library_ms": None,
                               "ms_16_20": rows[0][1], "bound_ms_16_20": rows[0][3],
                               "kernels_per_call": 1}


def b3_graph_replay(fn, x, args, g) -> bool:
    """One call of B3 (``fn``) captured in a CUDA graph and replayed, its
    outputs poisoned before each replay, gives the eager call's bits."""
    import torch

    eager = [t.clone() for t in fn(x, *args, g)]          # before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, *args, g)
    for _ in range(3):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(out, eager)):
            return False
    return True


# B3 past its unrolled instantiations (ROADMAP C10): the generic kernel
C10_HIDDEN = (17, 24, 32)
C10_TRAIN_HIDDEN = 24
C10_TRAIN_ROWS = 4096


def phase_c10(device):
    """B3 at hidden widths past 16 (its generic instantiation) against its
    plain version at the train path's 20->5 layer, B = 16600; a graph replay;
    then one fused train step of a JSC-HLF stack at H = 24 against the same
    step through the plain versions."""
    import torch
    from repro_torch.core.lut_layers import LUTDense
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused
    from repro_torch.train.steps import make_lut_train_step

    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator().manual_seed(SEED + 11)
    for hidden in C10_HIDDEN:
        layer = LUTDense(20, 5, hidden=hidden, device=device, generator=gen)
        x, args, g = b3_args(layer, rng, JSC_BATCH, device)
        rel = b3_check(f"20->5 H={hidden}", lut_dense_bwd_fused, x, args, g)
        worst = max(B3_NAMES, key=rel.get)
        kern = device_kernels(lambda: lut_dense_bwd_fused(x, *args, g))
        check(len(kern) == 1, f"B3 H={hidden}: {len(kern)} device kernels a call: {kern}")
        replay = hidden == C10_TRAIN_HIDDEN
        if replay:
            check(b3_graph_replay(lut_dense_bwd_fused, x, args, g),
                  f"B3 H={hidden}: a CUDA-graph replay differs from the eager call")
        ms = cuda_ms(lambda: lut_dense_bwd_fused(x, *args, g), iters=10)
        print(f"[C10] B3 20->5 H={hidden} B={JSC_BATCH} (generic instantiation): all "
              f"eight gradients within {B3_REL} of the plain version (worst {worst} "
              f"{rel[worst]:.3g}); two launches bitwise equal; "
              f"{'graph replay equal; ' if replay else ''}{len(kern)} device kernel a "
              f"call ({kern[0]}); {ms:.4f} ms")
    layers, hp, data = train_setup(device, hidden=C10_TRAIN_HIDDEN)
    batch = {k: v[:C10_TRAIN_ROWS] for k, v in train_batch(data, 0).items()}
    _, n_flips, worst = compare_step_to_plain(layers, hp, batch)
    step_fn, init_fn = make_lut_train_step(layers, hp)
    ops.reset_launch_counts()
    _, m = step_fn(init_fn(), batch)
    torch.cuda.synchronize()
    got = ops.launch_counts()
    check(got["lut_dense"] == 1 and got["lut_dense_bwd"] == 1 and bool(torch.isfinite(m["loss"])),
          f"C10 train step at H={C10_TRAIN_HIDDEN}: launches {got}, loss {float(m['loss'])}")
    print(f"[C10] one fused train step of the JSC-HLF stack at H={C10_TRAIN_HIDDEN}, "
          f"B={C10_TRAIN_ROWS}: loss, CE, EBOPs and every gradient on the card within "
          f"tolerance of the plain step (worst {worst:.3f} of it; {n_flips} cell codes "
          f"flip); the fused step launched B2 and B3 once each: {got}")


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


def b4_bound(chain, packed, b):
    """B4's bound on ``b`` rows: the input and output codes, the tables and
    the constants moved once, or the chain's integer operations at the
    FP32 rate, whichever is longer."""
    item = chain.consts.element_size()                # the compute dtype
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
    return bound(n_bytes, ops_row * b)


def b4_plan_text(chain, batches) -> str:
    """The chain's launch plan: resident stages, tile rows and grid by batch."""
    plan = getattr(chain, "plan", None)
    if plan is None:
        return "no launch plan (one 256-thread block per 128-row tile, tables read through L2)"
    where = ", ".join(f"stage {k}: {'shared' if off >= 0 else 'global'}"
                      for k, off in enumerate(plan.table_soff))
    tiles = "; ".join(f"B={b}: {t.tile_rows} rows x {t.n_tiles} tiles on {t.grid} blocks, "
                      f"{t.smem} B shared" for b in batches for t in (chain.tiles(b),))
    return (f"constants {'shared' if plan.consts_soff >= 0 else 'global'}, {where}; "
            f"{plan.n_bar} mbarriers; tile buffers strides {plan.stride_a}/{plan.stride_b}, "
            f"at most {plan.max_tile_rows} rows; {chain.blocks} resident blocks; {tiles}")


def b4_graph_replay(chain, x) -> bool:
    """One B4 call captured in a CUDA graph and replayed, its output
    poisoned before each replay, gives the eager call's codes."""
    import torch
    from repro_torch.kernels.lut_serve_cuda import run_chain

    eager = run_chain(chain, x).clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run_chain(chain, x)
    for _ in range(3):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            return False
    return True


def b4_codes(prog, rng, b, dtype, device):
    import torch
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(prog)
    codes = rng.integers(lo, hi + 1, (b, len(lo)), np.int64)
    return torch.as_tensor(codes, device=device).to(dtype)


# B4 on the JSC-HLF chain: every batch held bit for bit; the timing batches
B4_BATCHES = (1, 31, 129, 1024, 4099, 16600, 66400)
B4_TIMING_BATCHES = (1, 1024, 16600, 66400)


def phase_b4(device, prog, chain, xs, packed, max_err, report):
    """B4 on the served JSC-HLF chain: bit for bit equal to its plain version
    at every batch of ``B4_BATCHES``, two launches alike, a graph replay
    equal to an eager call, one device kernel a call; then timed at B =
    16600 and 1024 beside its bound and its plain version."""
    import torch
    from repro_torch.kernels.lut_serve_cuda import run_chain, run_chain_plain

    rng = np.random.default_rng(SEED + 12)
    for b in B4_BATCHES:
        x = b4_codes(prog, rng, b, chain.dtype, device)
        got = run_chain(chain, x)
        again = run_chain(chain, x)
        torch.cuda.synchronize()
        check(torch.equal(got, run_chain_plain(chain, x)), f"B4 != plain chain at B={b}")
        check(torch.equal(got, again), f"B4: two launches differ at B={b}")
    for b in SERVE_BATCHES:
        check(b4_graph_replay(chain, xs[b]),
              f"B4: a CUDA-graph replay differs from the eager call at B={b}")
    kern = device_kernels(lambda: run_chain(chain, xs[JSC_BATCH]))
    check(len(kern) == 1, f"B4: {len(kern)} device kernels a call: {kern}")
    print(f"[B4] JSC-HLF chain: bit for bit equal to the plain chain at B in "
          f"{list(B4_BATCHES)}, two launches alike; graph replay equal at B in "
          f"{list(SERVE_BATCHES)}; {len(kern)} device kernel a call ({kern[0]}); plan: "
          f"{b4_plan_text(chain, SERVE_BATCHES)}")
    x = xs[JSC_BATCH]
    b = x.shape[0]
    ms = cuda_ms(lambda: run_chain(chain, x), iters=50)
    plain_ms = cuda_ms(lambda: run_chain_plain(chain, x))
    small = xs[SERVE_BATCHES[0]]
    ms_small = cuda_ms(lambda: run_chain(chain, small), iters=50)
    b_ms, b_by = b4_bound(chain, packed, b)
    bs_ms, _ = b4_bound(chain, packed, small.shape[0])
    print(f"[B4] JSC-HLF chain B={b}: kernel {ms:.5f} ms, plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}); B={SERVE_BATCHES[0]}: kernel "
          f"{ms_small:.5f} ms, bound {bs_ms:.5f} ms")
    report["lut_serve"] = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                           "ms_1024": ms_small, "bound_ms_1024": bs_ms,
                           "kernels_per_call": 1}


def train_setup(device, hidden=HIDDEN):
    """The JSC-HLF train slice: layers, step, data and per-step batch indices
    (``examples/quickstart.py``'s configuration at the paper's batch; the
    stack's hidden width ``hidden``)."""
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
    x_host = int_to_float(ctr, TRAIN_IN_F).astype(np.float32)
    data = {"x": torch.as_tensor(x_host, device=device),
            "y": torch.as_tensor(ytr, device=device),
            "x_test": int_to_float(cte, TRAIN_IN_F).astype(np.float32),
            "codes_test": cte, "y_test": yte, "x_host": x_host, "y_host": ytr}
    idx = np.random.default_rng(SEED).integers(0, n_train, (steps, batch))
    data["idx"] = torch.as_tensor(idx, device=device)
    data["idx_host"] = idx
    layers = build_lut_stack(list(JSC_DIMS), hidden, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    hp = TrainHParams(adam=AdamConfig(lr=LR), beta=BetaSchedule(5e-7, 1e-4, steps),
                      lr_schedule=cosine_restarts(LR, first_period=max(steps // 2, 1),
                                                  warmup=min(30, steps // 2)),
                      lut_use_fused=True)
    return layers, hp, data


def train_batch(data, s):
    idx = data["idx"][s]
    return {"x": data["x"][idx], "y": data["y"][idx]}


def host_batch(data, s):
    """Step ``s``'s batch gathered on the host from the rows ``train_batch``
    gathers on the card: the same values, as numpy (the chunked loop's
    ``get_batch``)."""
    idx = data["idx_host"][s]
    return {"x": data["x_host"][idx], "y": data["y_host"][idx]}


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
    loss, ce, aux, grads = lut_loss_and_grads(layers, hp, step0.to(batch["x"].device),
                                              batch)
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


def schedule_ulps(hp, device, steps):
    """Largest difference, in float32 ulps, between beta and the learning
    rate of steps 0..steps-1 computed from a step counter on the card and
    the same on the CPU: ``(beta, lr)``."""
    import torch

    got = []
    for dev in (device, torch.device("cpu")):
        k = torch.zeros((), dtype=torch.int32, device=dev)
        vals = []
        for _ in range(steps):
            vals.append(torch.stack([hp.beta(k), hp.lr_schedule(k + 1)]))
            k = k + 1
        got.append(torch.stack(vals).cpu().numpy().view(np.int32).astype(np.int64))
    return tuple(int(u) for u in np.abs(got[0] - got[1]).max(axis=0))


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
    u_beta, u_lr = schedule_ulps(hp, device, TRAIN_STEPS)
    print(f"[train] beta and lr of steps 1-{TRAIN_STEPS} from the step counter on "
          f"the card vs on the CPU: at most {u_beta} and {u_lr} float32 ulps apart")
    return layers, hp, data, cpu_layers


def phase_train_run(device, layers, hp, data, cpu_layers):
    """Part 2, the path itself: TRAIN_STEPS fused steps, then evaluate, lower
    and serve the trained model."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.steps import make_lut_train_step, named_params

    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()
    check(opt["step"].device == layers[0].w0.device,
          f"train: the step counter is on {opt['step'].device}, not the card")
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
    serve_trained(device, layers, data, "[train]")
    return {"ms_step": float(np.mean(steady)), "host_ms_step": float(np.mean(steady_host)),
            "steps_per_s": TRAIN_STEPS / wall}


def serve_trained(device, layers, data, tag):
    """Evaluate the trained stack, lower it (eval forward == run_float
    exactly), build it behind the gate and serve the test rows through B4,
    bit-exact against the plain chain and ``DaisProgram.run``."""
    import torch
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain
    from repro_torch.serve.api import EngineSpec, build

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
    print(f"{tag} trained model: test accuracy {acc:.4f}; eval forward == "
          f"DaisProgram.run_float exactly on {len(codes)} rows; {prog.n_instrs()} "
          f"instrs; gate PASSED on path {engine.path}; {len(codes)} test rows "
          f"served through B4 bit-exact vs the plain chain and DaisProgram.run")


# the port's train kernels, by the names of their device kernels
KERNEL_MARKS = {"fake_quant": ("fq_column_kernel", "fq_general_kernel"),
                "lut_dense": ("lut_dense_forward_kernel",),
                "lut_dense_bwd": ("lut_dense_bwd_",)}


def kernel_counts(names) -> dict:
    """Device kernels of each of B1-B3 among the kernel names ``names``."""
    return {k: sum(any(m in n for m in marks) for n in names)
            for k, marks in KERNEL_MARKS.items()}


def trace_stats(prof, window_ms, n_steps, name="train_trace.json"):
    """Device busy time of ``n_steps`` profiled steps from the chrome trace,
    per step: busy ms, ms between the window's events, the idle share of the
    window, device kernels (with copies and fills), B1-B3's ms and device
    kernels, and the kernels that took the most device time; None when the
    trace holds no device activity."""
    from repro_torch.kernels import build as kbuild

    path = kbuild.BUILD_DIR / name
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh).get("traceEvents", [])
    kern = [e for e in trace if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]
    if not kern:
        return None
    by_name = {}
    for e in kern:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    busy = sum(by_name.values())
    marks = sum(KERNEL_MARKS.values(), ())
    mine = sum(v for k, v in by_name.items() if any(t in k for t in marks))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    counts = kernel_counts([e["name"] for e in kern if e.get("cat") == "kernel"])
    return {"busy": busy / n_steps, "window": window_ms / n_steps,
            "idle": 1 - busy / window_ms, "kernels": len(kern) / n_steps,
            "port_ms": mine / n_steps, "port_share": mine / busy,
            "counts": {k: v / n_steps for k, v in counts.items()},
            "top": [(k, v / n_steps) for k, v in top]}


def trace_summary(prof, window_ms, n_steps):
    """``trace_stats`` as one line."""
    st = trace_stats(prof, window_ms, n_steps)
    if st is None:
        return "no device kernels in the trace (device time not measured)"
    return (f"device busy {st['busy']:.4f} ms/step of {st['window']:.4f} ms/step "
            f"between events (idle share {st['idle']:.3f}); {st['kernels']:.0f} device "
            f"kernels per step; B1-B3 {st['port_ms']:.4f} ms/step ({st['port_share']:.3f} "
            f"of busy); top: " + "; ".join(f"{k[:60]} {v:.4f} ms" for k, v in st["top"]))


# --------------------------------------------------------------------------- #
# The chunked training loop (train/loop.py) on the train path: chunk_steps
# of the chunked runs (the reference's default, and a longer chunk), the
# boundary every run keeps (a checkpoint) and the step the crash run stops at
# (not the end of a chunk)
LOOP_CHUNKS = (8, 40)
LOOP_BOUNDARY = 100
LOOP_CRASH = 130
LOOP_TIMING_RUNS = 3
# kernel launches of one train step
PER_STEP = {"fake_quant": 2, "lut_dense": 1, "lut_dense_bwd": 1, "lut_serve": 0}


def state_bytes(layers, opt) -> dict:
    """Every parameter, BN stat and Adam tensor of a stack, as bytes by the
    reference's checkpoint path."""
    from repro_torch import interop

    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        else:
            out[path] = np.asarray(tree).tobytes()

    walk({"params": interop.stack_params_to_numpy(layers),
          "opt": interop.opt_state_to_numpy(layers, opt)}, "")
    return out


def check_same_state(got, want, what):
    diff = sorted(k for k in want if got.get(k) != want[k])
    check(got.keys() == want.keys() and not diff,
          f"loop: {what} differs from the per-step run in {diff[:6]}")


def loop_per_step(hp, data, layers):
    """TRAIN_STEPS steps one call each (the per-step loop of ``phase_train_run``):
    ``(opt_state, metrics (steps, 3) of loss/CE/EBOPs, timings)``."""
    import torch
    from repro_torch.train.steps import make_lut_train_step

    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()
    rows, host_ms = [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_all = time.perf_counter()
    ev[0].record()
    for s in range(TRAIN_STEPS):
        batch = train_batch(data, s)
        t0 = time.perf_counter()
        opt, m = step_fn(opt, batch)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        ev[s + 1].record()
        rows.append(torch.stack([m["loss"], m["ce"], m["ebops"]]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    dev = [ev[s].elapsed_time(ev[s + 1]) for s in range(TRAIN_STEPS)]
    stats = {"events": ev[0].elapsed_time(ev[-1]) / TRAIN_STEPS,
             "steady": float(np.mean(dev[10:])), "host": float(np.mean(host_ms[10:])),
             "steps_s": TRAIN_STEPS / wall, "peak": {1: torch.cuda.max_memory_allocated()}}
    return opt, torch.stack(rows).cpu().numpy(), stats


def loop_chunked(hp, data, layers, mode, chunk_steps, start=0, stop=None,
                 opt=None, on_chunk=None):
    """Steps ``[start, stop)`` through ``run_chunked`` in ``mode`` with the
    boundary ``LOOP_BOUNDARY``, batches from ``host_batch`` on the prefetch
    thread; each chunk must launch B1 x2, B2 and B3 once per step (and once
    more for a graph's warm-up step).  Returns the state, metrics, the chunks
    ``(step, k, compiled)`` and timings: ms/step between CUDA events over the
    run, steady ms/step and host (enqueue) ms/step over the chunks that did
    not capture, steps/s over the run, the capture time (the capturing
    chunk's time less k steady steps) and peak allocated bytes per k."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train.loop import run_chunked
    from repro_torch.train.steps import make_lut_train_step, named_params

    stop = TRAIN_STEPS if stop is None else stop
    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn() if opt is None else opt
    chunks, rows, peaks = [], [], {}
    last = {}

    def keep(r):
        now = ops.launch_counts()
        warm = 1 if mode == "graph" and r.compiled else 0
        want = {n: c * (r.k + warm) for n, c in PER_STEP.items()}
        got = {n: now[n] - last[n] for n in now}
        check(got == want, f"loop {mode}/{chunk_steps}: chunk ({r.step}, {r.k}) "
              f"launched {got}, not {want}")
        last.update(now)
        if r.compiled:
            peaks[r.k] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        chunks.append((r.step, r.k, r.compiled, r.dt_s, r.host_s))
        rows.append(np.stack([r.metrics["loss"], r.metrics["ce"], r.metrics["ebops"]], 1))
        if on_chunk is not None:
            on_chunk(r)

    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last.update(ops.launch_counts())
    t_all = time.perf_counter()
    e0.record()
    _, opt, _ = run_chunked(step_fn, named_params(layers), opt, lambda s: host_batch(data, s),
                            start, stop, chunk_steps=chunk_steps,
                            boundaries=(LOOP_BOUNDARY,), mode=mode, on_chunk=keep)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    steady = [c for c in chunks if not c[2]]
    n = sum(c[1] for c in steady) or float("nan")      # nan: every chunk captured
    ms = 1e3 * sum(c[3] for c in steady) / n
    stats = {"events": e0.elapsed_time(e1) / (stop - start), "steady": ms,
             "host": 1e3 * sum(c[4] for c in steady) / n, "steps_s": (stop - start) / wall,
             "capture_ms": {c[1]: 1e3 * c[3] - c[1] * ms for c in chunks if c[2]},
             "peak": peaks}
    return {"opt": opt, "hist": np.concatenate(rows), "chunks": [c[:3] for c in chunks],
            "stats": stats}


def phase_loop(device):
    """The chunked loop on the train path: per step, eager chunks and graph
    chunks from one start, bit for bit equal; a crash at an unaligned step
    and a resume from a checkpoint, bit for bit equal to the straight run;
    the graph-trained model lowered, gated and served through B4."""
    import shutil

    from repro_torch.ckpt.store import CheckpointStore
    from repro_torch.kernels import build as kbuild
    from repro_torch.train.steps import make_lut_train_step

    layers0, hp, data = train_setup(device)

    def fresh():
        return [copy.deepcopy(layer) for layer in layers0]

    t0 = time.monotonic()
    layers = fresh()
    opt, hist, _ = loop_per_step(hp, data, layers)
    want = state_bytes(layers, opt)
    graph_layers = None
    for mode, chunk in (("eager", LOOP_CHUNKS[0]), ("graph", LOOP_CHUNKS[0]),
                        ("graph", LOOP_CHUNKS[1])):
        layers = fresh()
        out = loop_chunked(hp, data, layers, mode, chunk)
        check_same_state(state_bytes(layers, out["opt"]), want, f"{mode} chunks of {chunk}")
        check(out["hist"].tobytes() == hist.tobytes(),
              f"loop: loss/CE/EBOPs of {mode} chunks of {chunk} differ from per-step")
        ks = sorted({k for _, k, _ in out["chunks"]}, reverse=True)
        print(f"[loop] {mode} chunks of {chunk} (k in {ks}, boundary {LOOP_BOUNDARY}, "
              f"{len(out['chunks'])} chunks): params, Adam state, BN stats and the "
              f"{TRAIN_STEPS} steps' loss/CE/EBOPs bit for bit equal to the per-step loop")
        graph_layers = layers
    # crash at an unaligned step, resume from the checkpoint at the boundary
    ckpt = kbuild.BUILD_DIR / "loop_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    store = CheckpointStore(str(ckpt), keep=2)
    layers = fresh()

    def save(r):
        if r.step + r.k == LOOP_BOUNDARY:
            store.save(LOOP_BOUNDARY, layers, r.opt_state, extra={"seed": SEED}, blocking=True)

    loop_chunked(hp, data, layers, "graph", LOOP_CHUNKS[1], stop=LOOP_CRASH, on_chunk=save)
    check(store.list_steps() == [LOOP_BOUNDARY], f"loop: checkpoints {store.list_steps()}")
    layers = fresh()
    _, init_fn = make_lut_train_step(layers, hp)
    layers, opt, manifest = store.restore(layers, init_fn())
    check(manifest == {"step": LOOP_BOUNDARY, "seed": SEED}, f"loop: manifest {manifest}")
    out = loop_chunked(hp, data, layers, "graph", LOOP_CHUNKS[1], start=LOOP_BOUNDARY, opt=opt)
    check_same_state(state_bytes(layers, out["opt"]), want, "the resumed run")
    check(out["hist"].tobytes() == hist[LOOP_BOUNDARY:].tobytes(),
          "loop: loss/CE/EBOPs of the resumed run differ")
    print(f"[loop] graph chunks of {LOOP_CHUNKS[1]}: stopped at step {LOOP_CRASH}, "
          f"restored the checkpoint of step {LOOP_BOUNDARY} into fresh layers and Adam "
          f"state, ran {LOOP_BOUNDARY}-{TRAIN_STEPS} (chunks {out['chunks']}): bit for bit "
          f"equal to the straight run ({time.monotonic() - t0:.1f}s for the phase so far)")
    serve_trained(device, graph_layers, data, "[loop]")


def profile_window(fn, n_steps, name):
    """``trace_stats`` of one call of ``fn`` (``n_steps`` train steps) under
    torch.profiler, CUDA events around it, and the launch counts it added;
    a profile that records no device kernel is taken again (PERF.md §7)."""
    import torch
    from repro_torch.kernels import ops

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILE_TRIES):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        before = ops.launch_counts()
        with torch.profiler.profile(activities=activities) as prof:
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
        after = ops.launch_counts()
        st = trace_stats(prof, e0.elapsed_time(e1), n_steps, name)
        if st is not None:
            st["launches"] = {k: (after[k] - before[k]) / n_steps for k in KERNEL_MARKS}
            return st
    raise SmokeError(f"{name}: no device kernel in {PROFILE_TRIES} profiles")


def loop_profiles(device, hp, data, layers0):
    """Profiles of the three modes on copies of the start: 5 per-step steps,
    one eager chunk of 8, one graph replay of 8 and of 40 (after the chunk
    that captured it).  Each replayed step must run B1 twice, B2 and B3 once
    on the device, as many as the launch counters add."""
    import torch
    from repro_torch.data.pipeline import stack_batches
    from repro_torch.train.loop import make_chunked_step
    from repro_torch.train.steps import make_lut_train_step

    out = {}
    step_fn, init_fn = make_lut_train_step([copy.deepcopy(l) for l in layers0], hp)
    opt = init_fn()
    for s in range(3):
        opt, _ = step_fn(opt, train_batch(data, s))

    def steps():
        nonlocal opt
        for s in range(3, 8):
            opt, _ = step_fn(opt, train_batch(data, s))

    out[("step", None)] = profile_window(steps, 5, "loop_step.json")
    for mode, k in (("eager", LOOP_CHUNKS[0]), ("graph", LOOP_CHUNKS[0]),
                    ("graph", LOOP_CHUNKS[1])):
        step_fn, init_fn = make_lut_train_step([copy.deepcopy(l) for l in layers0], hp)
        chunk_fn = make_chunked_step(step_fn, mode=mode, device=device)
        batches = {n: torch.as_tensor(a, device=device)
                   for n, a in stack_batches(lambda s: host_batch(data, s), 0, k).items()}
        state = {"opt": init_fn()}

        def call():
            state["opt"], _ = chunk_fn(state["opt"], batches)

        call()                                   # eager: warm; graph: capture + replay
        st = profile_window(call, k, f"loop_{mode}_{k}.json")
        if mode == "graph":
            want = {n: float(c) for n, c in PER_STEP.items() if n in KERNEL_MARKS}
            check(st["counts"] == want and st["launches"] == want,
                  f"loop: a replayed step of {k} ran {st['counts']} device kernels and "
                  f"counted {st['launches']} launches, not {want}")
        out[(mode, k)] = st
    return out


def loop_timings(device, tag=""):
    """The modes timed in ``LOOP_TIMING_RUNS`` interleaved rounds (per step,
    eager chunks of 8, graph chunks of 8 and of 40, each from the same start),
    printed as medians and ranges, then one profile of each."""
    layers0, hp, data = train_setup(device)
    modes = (("step", None), ("eager", LOOP_CHUNKS[0]), ("graph", LOOP_CHUNKS[0]),
             ("graph", LOOP_CHUNKS[1]))
    got = {m: [] for m in modes}
    for _ in range(LOOP_TIMING_RUNS):
        for mode, chunk in modes:
            layers = [copy.deepcopy(l) for l in layers0]
            got[(mode, chunk)].append(
                loop_per_step(hp, data, layers)[2] if mode == "step"
                else loop_chunked(hp, data, layers, mode, chunk)["stats"])
    prof = loop_profiles(device, hp, data, layers0)

    def spread(vals, fmt="{:.4f}"):
        return (fmt.format(float(np.median(vals))) + " [" + fmt.format(min(vals)) + ", "
                + fmt.format(max(vals)) + "]")

    summary = {}
    for m in modes:
        runs, st = got[m], prof[m]
        name = "per step" if m[0] == "step" else f"{m[0]} chunks of {m[1]}"
        steady = float(np.median([r["steady"] for r in runs]))
        idle = 1 - st["busy"] / steady
        peaks = {k: [r["peak"][k] / 2**20 for r in runs] for k in runs[0]["peak"]}
        line = (f"[loop{tag}] {name}, {LOOP_TIMING_RUNS} runs of {TRAIN_STEPS} steps at "
                f"B={JSC_BATCH}, median [min, max]: ms/step between CUDA events "
                f"{spread([r['events'] for r in runs])}; steady ms/step "
                f"{spread([r['steady'] for r in runs])}; host ms/step (enqueue) "
                f"{spread([r['host'] for r in runs])}; steps/s over the loop "
                f"{spread([r['steps_s'] for r in runs], '{:.2f}')}; profile: device busy "
                f"{st['busy']:.4f} ms/step, idle share {idle:.3f} of the steady step "
                f"({st['idle']:.3f} of the profiled window), {st['kernels']:.1f} device "
                f"kernels/step, B1/B2/B3 device kernels/step {st['counts']}, B1-B3 "
                f"{st['port_ms']:.4f} ms/step; peak MiB allocated per k "
                + ", ".join(f"{k}: {spread(v, '{:.1f}')}" for k, v in peaks.items()))
        if m[0] == "graph":
            caps = {k: [r["capture_ms"][k] for r in runs] for k in runs[0]["capture_ms"]}
            line += "; capture ms per k (warm-up step included) " + ", ".join(
                f"{k}: {spread(v, '{:.1f}')}" for k, v in caps.items())
        print(line)
        summary[name] = {"steady": steady, "idle": idle}
    return summary


# --------------------------------------------------------------------------- #
# The PID hybrid (models/pid.py): examples/pid_hybrid.py's non-smoke settings
# at cepc_waveform's own 3000-sample length (150 windows), the widths of
# repro/models/pid.py (WINDOW 20, 8 features, LUT-Conv 8->8 and 8->4, kernel 3
# SAME, head 4->1, hidden 8); served over contexts of 100 and 3000 samples
PID_WF_LEN = 3000
PID_N_TRAIN, PID_N_TEST, PID_N_SERVE = 1200, 400, 1024
PID_BATCH = 128
PID_STEPS = 500
PID_SERVE = {100: (1024, 16600), 3000: (1024,)}
PID_N_BATCHES = 3
# a pid step on the example's path: B1 for the front's two quantizers and
# each LUT layer's two (the LUT layers on the einsum path, as the reference's)
PID_PER_STEP = {"fake_quant": 8, "lut_dense": 0, "lut_dense_bwd": 0, "lut_serve": 0}
# the same step with the LUT layers on the fused pair (B2 forward, B3 backward)
PID_FUSED_STEP = {"fake_quant": 2, "lut_dense": 3, "lut_dense_bwd": 3, "lut_serve": 0}
PID_PROFILE_STEPS = (200, 205)


def pid_setup(device):
    """The pid train slice: layers from seed 0 and the ADC-quantized train,
    test and serve waveforms with the per-step batch indices."""
    import torch
    from repro_torch.examples.pid_hybrid import adc_data
    from repro_torch.models.pid import build_pid_layers

    t0 = time.monotonic()
    wf, cnt, _ = adc_data(SEED, PID_N_TRAIN, PID_WF_LEN, "train")
    wf_te, cnt_te, sp_te = adc_data(SEED, PID_N_TEST, PID_WF_LEN, "test")
    wf_sv, _, _ = adc_data(SEED, PID_N_SERVE, PID_WF_LEN, "val")
    idx = np.random.default_rng(SEED).integers(0, PID_N_TRAIN, (PID_STEPS, PID_BATCH))
    data = {"wf": torch.as_tensor(wf, device=device),
            "cnt": torch.as_tensor(cnt, device=device),
            "idx": torch.as_tensor(idx, device=device),
            "wf_test": wf_te, "cnt_test": cnt_te, "sp_test": sp_te, "wf_serve": wf_sv}
    layers = build_pid_layers(device=device, generator=torch.Generator().manual_seed(SEED))
    print(f"[pid] data: {PID_N_TRAIN} train, {PID_N_TEST} test, {PID_N_SERVE} serve "
          f"waveforms of {PID_WF_LEN} samples from cepc_waveform on the 12-bit ADC grid "
          f"({time.monotonic() - t0:.1f}s)")
    return layers, data


def pid_batch(data, s):
    idx = data["idx"][s]
    return data["wf"][idx], data["cnt"][idx]


def pid_cells(layers, wf):
    """Train-mode SAT output codes of the hybrid's LUT cells, layer by layer
    on the stack's own input (``wf`` on the layers' device)."""
    import torch

    front, *luts = layers
    out = []
    with torch.no_grad():
        front.train(True)
        h, _ = front(wf[..., None])
        for layer in luts:
            layer.train(True)
            x = layer._patches(h) if hasattr(layer, "_patches") else h
            yq, _ = getattr(layer, "dense", layer)._cells(x, True)
            out.append(yq.cpu())
            h = torch.sum(yq, dim=-2)
    return out


def compare_pid_step_to_plain(layers, wf, cnt, fused=None):
    """One pid step's loss, MSE, EBOPs and gradients on the card against the
    same step through the plain versions on the CPU.  Returns the CPU copy,
    the cells whose code flips between the two, the worst gradient error
    over its tolerance and the launches of the card's step."""
    import torch
    from repro_torch.examples.pid_hybrid import pid_loss_and_grads
    from repro_torch.kernels import ops

    cpu_layers = [copy.deepcopy(layer).to("cpu") for layer in layers]
    n_flips = sum(int((a != b).sum()) for a, b in
                  zip(pid_cells(layers, wf), pid_cells(cpu_layers, wf.cpu())))
    torch.cuda.synchronize()
    before = ops.launch_counts()
    loss, mse, eb, grads = pid_loss_and_grads(layers, wf, cnt, fused=fused)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    closs, cmse, ceb, cgrads = pid_loss_and_grads(cpu_layers, wf.cpu(), cnt.cpu(),
                                                  fused=fused)
    rows = cnt.numel()                      # MSE is a mean over waveform windows
    for name, a, c in (("loss", loss, closs), ("mse", mse, cmse), ("ebops", eb, ceb)):
        a, c = float(a), float(c)
        check(abs(a - c) <= 1e-5 * abs(c) + 1e-6 + FLIP_GRAD / rows * n_flips,
              f"pid step: {name} {a} on the card vs {c} plain")
    worst = 0.0
    for path, g in grads.items():
        w = cgrads[path]
        tol = GRAD_RTOL * float(w.abs().max()) + GRAD_ATOL + FLIP_GRAD / rows * n_flips
        err = float((g.cpu() - w).abs().max())
        worst = max(worst, err / tol)
        check(err <= tol, f"pid step: gradient {path} off by {err} > {tol}")
    return cpu_layers, n_flips, worst, {k: after[k] - before[k] for k in after}


def phase_pid(device):
    """Part 1 of the pid path: step 1 against the plain versions (its
    launches are comparisons and are made before the path's window)."""
    from repro_torch.examples.pid_hybrid import make_pid_train_step

    layers, data = pid_setup(device)
    t0 = time.monotonic()
    wf, cnt = pid_batch(data, 0)
    cpu_layers, n_flips, worst, got = compare_pid_step_to_plain(layers, wf, cnt)
    check(got == PID_PER_STEP, f"pid step launched {got}, not {PID_PER_STEP}")
    cpu_step, cpu_init = make_pid_train_step(cpu_layers, PID_STEPS)
    cpu_step(cpu_init(), wf.cpu(), cnt.cpu())
    print(f"[pid] step 1 at B={PID_BATCH} x {PID_WF_LEN} samples: loss, MSE, EBOPs and "
          f"every gradient on the card agree with the plain versions (CPU) within "
          f"tolerance (worst {worst:.3f} of it; {n_flips} cell codes flip between the "
          f"two; {time.monotonic() - t0:.1f}s)")
    return layers, data, cpu_layers


def phase_pid_run(device, layers, data, cpu_layers):
    """Part 2, the path itself: PID_STEPS steps, test separation, then lower
    at each context of PID_SERVE, build behind the gate and serve request
    batches through B4.  Returns the built chains for B4's timings."""
    import torch
    from repro_torch.examples.pid_hybrid import (eval_counts, make_pid_train_step,
                                                 separation)
    from repro_torch.kernels import ops
    from repro_torch.models.pid import pid_named_params

    step_fn, init_fn = make_pid_train_step(layers, PID_STEPS)
    opt = init_fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(PID_STEPS)]
    metrics, host_ms = [], []
    prof_lo, prof_hi = PID_PROFILE_STEPS
    lr0 = None
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for s in range(PID_STEPS):
        if s == prof_lo:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        before = ops.launch_counts()
        wf, cnt = pid_batch(data, s)
        t0 = time.perf_counter()
        events[s][0].record()
        opt, m = step_fn(opt, wf, cnt)
        events[s][1].record()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if s == prof_hi - 1:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            window_ms = events[prof_lo][0].elapsed_time(events[s][1])
            profile = trace_stats(prof, window_ms, prof_hi - prof_lo, "pid_trace.json")
        after = ops.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        check(got == PID_PER_STEP, f"pid step {s + 1} launched {got}, not {PID_PER_STEP}")
        metrics.append(torch.stack([m["loss"], m["mse"], m["ebops"]]))
        if s == 0:
            lr0 = float(m["lr"])
            card = pid_named_params(layers)
            n_far = 0
            for path, p in pid_named_params(cpu_layers).items():
                d = (card[path].detach().cpu() - p.detach()).abs()
                check(float(d.max()) <= 2 * lr0 + 1e-6,
                      f"pid step 1: {path} moved {float(d.max())} from plain")
                n_far += int((d > 1e-3 * lr0).sum())
            n_all = sum(p.numel() for p in card.values())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    dev_ms = [a.elapsed_time(b) for a, b in events]
    hist = torch.stack(metrics).cpu().numpy()
    check(bool(np.isfinite(hist).all()), "pid: a non-finite loss, MSE or EBOPs")
    mse_first, mse_last = float(hist[:10, 1].mean()), float(hist[-10:, 1].mean())
    check(mse_last < mse_first, f"pid: MSE did not fall ({mse_first} -> {mse_last})")
    keep = [k for k in range(10, PID_STEPS) if not prof_lo <= k < prof_hi]
    steady, steady_host = [dev_ms[k] for k in keep], [host_ms[k] for k in keep]
    print(f"[pid] {PID_STEPS} steps at B={PID_BATCH} x {PID_WF_LEN} samples, each "
          f"launching B1 x8 (LUT layers on the einsum path, as the reference's); step 1 "
          f"params within 2*lr of plain ({n_far} of {n_all} elements beyond 1e-3*lr); "
          f"mean MSE first 10 {mse_first:.4f} -> last 10 {mse_last:.4f}; EBOPs "
          f"{hist[0, 2]:.0f} -> {hist[-1, 2]:.0f}")
    print(f"[pid] ms/step between CUDA events (steps 11-{PID_STEPS} outside the profiled "
          f"window) mean {np.mean(steady):.4f} median {np.median(steady):.4f}; host "
          f"ms/step (enqueue) mean {np.mean(steady_host):.4f}; {PID_STEPS / wall:.2f} "
          f"steps/s over the whole loop ({wall:.3f}s)")
    if profile is None:
        print("[pid] torch.profiler: no device kernels in the trace (device time not "
              "measured)")
    else:
        print(f"[pid] torch.profiler, steps {prof_lo + 1}-{prof_hi}: device busy "
              f"{profile['busy']:.4f} ms/step of {profile['window']:.4f} between events "
              f"(idle share {profile['idle']:.3f}); {profile['kernels']:.0f} device kernels "
              f"per step; B1 {profile['port_ms']:.4f} ms/step ({profile['port_share']:.3f} "
              f"of busy), B1 device kernels/step {profile['counts']['fake_quant']:.0f}; "
              f"top: " + "; ".join(f"{k[:60]} {v:.4f} ms" for k, v in profile["top"]))
    t0 = time.monotonic()
    pred = eval_counts(layers, data["wf_test"], device)
    s_pred = separation(pred, data["sp_test"])
    s_true = separation(data["cnt_test"], data["sp_test"])
    resid = float(np.abs(pred.sum(1) - data["cnt_test"].sum(1)).mean())
    print(f"[pid] test separation power {s_pred:.4f} (truth-count reference "
          f"{s_true:.4f}; the reference example asks for more than half of it); mean "
          f"|count error| per waveform {resid:.3f} ({time.monotonic() - t0:.1f}s)")
    check(np.isfinite(s_pred), "pid: separation power is not finite")
    check(s_pred > 0.5 * s_true, f"pid: separation power {s_pred:.4f} is not more than "
          f"half the truth-count reference {s_true:.4f}")
    served = {ctx: pid_serve(device, layers, data, ctx) for ctx in PID_SERVE}
    return {"ms_step": float(np.mean(steady)), "host_ms_step": float(np.mean(steady_host)),
            "steps_per_s": PID_STEPS / wall, "sep": s_pred, "sep_true": s_true,
            "served": served}


def pid_serve(device, layers, data, ctx):
    """Lower the trained hybrid over ``ctx`` samples, hold its eval forward
    to ``run_float`` (``bias_gap``: bit for bit with the front's bias on the
    program's grid; with the float bias moved windows only next to lc1 input
    ties, and the gap's distribution printed, ROADMAP C12), build it behind the gate
    and serve ``PID_N_BATCHES`` request batches of each size of
    ``PID_SERVE[ctx]`` through B4: the first of waveform contexts, the
    others of random in-range codes, each equal to the plain chain bit for
    bit in one B4 launch, the first also to ``DaisProgram.run``."""
    import torch
    from repro_torch.core.lower import lower
    from repro_torch.core.quant import quantize_to_int
    from repro_torch.examples.pid_hybrid import bias_gap
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain
    from repro_torch.models.pid import IN_F, IN_I, build_pid_graph
    from repro_torch.serve.api import EngineSpec, build

    t0 = time.monotonic()
    prog = lower(build_pid_graph(layers, n_samples=ctx))
    t_lower = time.monotonic() - t0
    wf_te = data["wf_test"][:, :ctx]
    gap = bias_gap(layers, wf_te, prog.run_float(wf_te)[:, 0], device)
    built = build(prog, EngineSpec(engine="pallas", require="pallas", verify="full",
                                   n_random=1024, seed=SEED), device=device)
    engine = built.engine
    chain, packed = plain_chain(prog, engine, device)
    kinds = "/".join(st.kind for st in packed.stages)
    print(f"[pid] ctx={ctx}: lowered in {t_lower:.2f}s to {prog.n_instrs()} instrs "
          f"{prog.count_ops()}; eval forward with the front's bias on the program's "
          f"grid == run_float exactly on {len(wf_te)} test waveforms; with its float bias "
          f"max|d| {gap['dq']:.4g} in {gap['n_dq']} of them (|d|: waveforms "
          f"{gap['hist']}), each moved window next to one of {gap['tie_sites']} lc1 "
          f"input ties in {gap['n_tie']} waveforms (C12); gate PASSED on "
          f"{built.attestation['random']} random rows, path {engine.path}, "
          f"{str(engine.dtype).replace('torch.', '')}, stages {kinds}, "
          f"{packed.table_bytes()} table bytes (per stage "
          f"{[0 if st.table is None else st.table.nbytes for st in packed.stages]}) "
          f"(compile {built.timings['compile_s']:.2f}s, gate {built.timings['gate_s']:.2f}s)")
    print(f"[pid] ctx={ctx}: B4 plan: {b4_plan_text(chain, PID_SERVE[ctx])}")
    contexts = quantize_to_int(data["wf_serve"].reshape(-1, ctx), IN_F, IN_I, False, "SAT")
    rng = np.random.default_rng(SEED + 20)
    xs = {}
    for b in PID_SERVE[ctx]:
        times = []
        for k in range(PID_N_BATCHES):
            if k == 0:
                codes = contexts[:b]
                check(len(codes) == b, f"pid ctx={ctx}: {len(codes)} contexts for B={b}")
                x = torch.as_tensor(codes, device=device).to(engine.dtype)
            else:
                x = b4_codes(prog, rng, b, engine.dtype, device)
            torch.cuda.synchronize()
            before = ops.launch_counts()["lut_serve"]
            t1 = time.perf_counter()
            out = engine.run(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            check(ops.launch_counts()["lut_serve"] == before + 1,
                  f"pid ctx={ctx}: B4 did not launch exactly once for a batch")
            check(out.shape == (b, 1) and torch.equal(out, run_chain_plain(chain, x)),
                  f"pid ctx={ctx}: B4 != the plain chain at B={b}")
            if k == 0:
                check(np.array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes)),
                      f"pid ctx={ctx}: served batch != DaisProgram.run at B={b}")
        xs[b] = x
        print(f"[pid] ctx={ctx}: {PID_N_BATCHES} batches x {b} rows (the first of "
              f"waveform contexts, also vs DaisProgram.run) bit-exact vs the plain "
              f"chain, one B4 launch each; host batch times ms: "
              + " ".join(f"{t:.3f}" for t in times))
    return {"chain": chain, "packed": packed, "xs": xs, "n_instrs": prog.n_instrs()}


def pid_b1_cases(rng, device):
    """B1 at the pid path's calls: the front's per-channel SAT on the
    patches (128, 150, 20) with widths (20,) and per-element SAT on its
    weights (20, 8); the LUT-Convs' WRAP on the expand views of their
    patches (128, 150, 24) -> (..., 24, 8) and (..., 24, 4) and SAT on the
    cell outputs; widths with pruned cells."""
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def widths(shape, f_lo, f_hi, i_lo, i_hi):
        f = rng.integers(f_lo, f_hi, shape).astype(np.float32)
        i = rng.integers(i_lo, i_hi, shape).astype(np.float32)
        f.reshape(-1)[:2] = -8.0                  # pruned
        return t(f), t(i)

    sites = PID_WF_LEN // 20
    cases = []
    f, i = widths((20,), 3, 9, 1, 4)
    cases.append(("pid front SAT, per channel", t(rng.normal(0, 2, (PID_BATCH, sites, 20))),
                  f, i, True, "SAT"))
    f, i = widths((20, 8), 3, 9, -1, 2)
    cases.append(("pid front weights SAT, per element", t(rng.normal(0, 0.3, (20, 8))),
                  f, i, True, "SAT"))
    src = t(rng.normal(0, 3, (PID_BATCH, sites, 24)))
    for c_out in (8, 4):
        f, i = widths((24, c_out), 1, 7, 0, 5)
        cases.append((f"pid LUT-Conv 24->{c_out} WRAP in (expand view)",
                      src[..., None].expand(PID_BATCH, sites, 24, c_out), f, i, True, "WRAP"))
        f, i = widths((24, c_out), 1, 7, 0, 4)
        cases.append((f"pid LUT-Conv 24->{c_out} SAT out",
                      t(rng.normal(0, 2, (PID_BATCH, sites, 24, c_out))), f, i, True, "SAT"))
    return cases


def phase_pid_b1(device, report):
    """B1 at the pid shapes: bit for bit against its plain version, then
    timed with a cold L2 beside its bounds and its plain version."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_fused
    from repro_torch.kernels.ref import fake_quant_ref

    rng = np.random.default_rng(SEED + 21)
    cases = pid_b1_cases(rng, device)
    for case in cases:
        b1_check(*case)
    by_label = {c[0]: c for c in cases}
    out = {}

    def pool_of(x):
        n = max(2, -(-3 * L2_FLUSH_BYTES // (8 * x.numel())))
        return [torch.randn(x.shape, device=device) * 2 for _ in range(n)]

    for key, label in (("channel", "pid front SAT, per channel"),
                       ("expand", "pid LUT-Conv 24->8 WRAP in (expand view)")):
        _l, x, f, i, signed, ov = by_label[label]
        if key == "expand":
            src_pool = pool_of(x[..., 0])
            shape = x.shape
            view = lambda s: s[..., None].expand(shape)
            ms = cuda_ms_cold(lambda s: fake_quant_fused(view(s), f, i, signed=signed,
                                                         overflow=ov), src_pool)
            plain = cuda_ms_cold(lambda s: fake_quant_ref(view(s), f, i, signed, ov),
                                 src_pool, iters=8)
            n_bytes = 4 * x.numel() + 4 * x[..., 0].numel() + 8 * f.numel()
        else:
            pool = pool_of(x)
            ms = cuda_ms_cold(lambda a: fake_quant_fused(a, f, i, signed=signed,
                                                         overflow=ov), pool)
            plain = cuda_ms_cold(lambda a: fake_quant_ref(a, f, i, signed, ov), pool,
                                 iters=8)
            n_bytes = 8 * x.numel() + 8 * f.numel()
        b_ms, b_by = bound(n_bytes, 10 * x.numel())
        out[key] = (ms, plain, b_ms, b_by, tuple(x.shape))
    _l, w, f, i, signed, ov = by_label["pid front weights SAT, per element"]
    ms_w = cuda_ms(lambda: fake_quant_fused(w, f, i, signed=signed, overflow=ov), iters=50)
    plain_w = cuda_ms(lambda: fake_quant_ref(w, f, i, signed, ov), iters=50)
    bw_ms, bw_by = bound(16 * w.numel(), 10 * w.numel())
    for key, what in (("channel", "front SAT per channel"),
                      ("expand", "LUT-Conv 24->8 WRAP on the expand view")):
        ms, plain, b_ms, b_by, shape = out[key]
        print(f"[pid-B1] {what}, x {shape}, cold L2: kernel {ms:.5f} ms, plain "
              f"{plain:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
    print(f"[pid-B1] front weights SAT per element (20, 8), warm: kernel {ms_w:.5f} ms, "
          f"plain {plain_w:.5f} ms, bound {bw_ms:.6f} ms ({bw_by}; a launch sets it)")
    report["fake_quant"].update({
        "pid_sat_channel_ms": out["channel"][0], "pid_sat_channel_plain_ms": out["channel"][1],
        "pid_sat_channel_bound_ms": out["channel"][2],
        "pid_expand_wrap_ms": out["expand"][0], "pid_expand_wrap_plain_ms": out["expand"][1],
        "pid_expand_bound_ms": out["expand"][2],
        "pid_sat_element_ms": ms_w, "pid_sat_element_plain_ms": plain_w,
        "pid_sat_element_bound_ms": bw_ms})


def phase_pid_fused(device, layers, data):
    """One pid step with the LUT layers on the fused pair (B2 forward, B3
    backward at 24->8, 24->4 and 4->1, H = 8, 19,200 rows) against the same
    step through the plain versions: a check of the conv layers' fused
    route, not the example's path."""
    wf, cnt = pid_batch(data, 1)
    fresh = [copy.deepcopy(layer) for layer in layers]
    _cpu, n_flips, worst, got = compare_pid_step_to_plain(fresh, wf, cnt, fused=True)
    check(got == PID_FUSED_STEP, f"fused pid step launched {got}, not {PID_FUSED_STEP}")
    print(f"[pid-fused] one step of the trained hybrid with its LUT layers on B2/B3 "
          f"({PID_BATCH * PID_WF_LEN // 20} rows): launches {got}; loss, MSE, EBOPs and "
          f"every gradient agree with the plain step (CPU) within tolerance (worst "
          f"{worst:.3f} of it; {n_flips} cell codes flip between the two)")


def phase_pid_b4(device, served, report):
    """B4 on the pid chains: a graph replay equal to an eager call at each
    context, then timed beside its bound and its plain version."""
    from repro_torch.kernels.lut_serve_cuda import run_chain, run_chain_plain

    for ctx, sv in served.items():
        chain, packed = sv["chain"], sv["packed"]
        for b, x in sv["xs"].items():
            check(b4_graph_replay(chain, x),
                  f"B4 pid ctx={ctx}: a graph replay differs from the eager call at B={b}")
            ms = cuda_ms(lambda: run_chain(chain, x), iters=50)
            plain = cuda_ms(lambda: run_chain_plain(chain, x), iters=5)
            b_ms, b_by = b4_bound(chain, packed, b)
            print(f"[pid-B4] ctx={ctx} B={b}: kernel {ms:.5f} ms, plain {plain:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}); graph replay equal to eager")
            tag = f"pid_ctx{ctx}_b{b}"
            report["lut_serve"].update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain,
                                        f"{tag}_bound_ms": b_ms})


# --------------------------------------------------------------------------- #
# Phase 11: the generic op-group runner and the IR tooling (dead-cell
# elimination, narrow=False, Verilog, RTL simulation, lint) on the programs of
# the models the train and pid paths trained
TOOL_BATCHES = (1024, 16600)
TOOL_N_BATCHES = 8
TOOL_PID_BATCHES = (1024, 16600)
TOOL_PID_N_BATCHES = 3
TOOL_CTX = 100              # the pid context of the DCE, narrow and RTL checks
TOOL_ONE_WINDOW = 20        # C4: the pid context that does not compose
TOOL_RTL_ROWS = 512
TOOL_TIMED_CALLS = 20
TOOL_PROFILED_CALLS = 5


def tool_codes(prog, b, n, seed):
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi + 1, (b, len(lo)), np.int64) for _ in range(n)]


def tool_serve(tag, engine, batches, b4_per_batch, oracle=None, peer=None):
    """Serve every batch of host codes in ``batches`` through ``engine``,
    each launching B4 ``b4_per_batch`` times, equal bit for bit to
    ``peer``'s outputs (host arrays, batch by batch) and to ``oracle.run``
    where given; returns the outputs, brought to the host by ``.cpu()``."""
    import torch
    from repro_torch.kernels import ops

    outs = []
    for k, codes in enumerate(batches):
        x = torch.as_tensor(codes, device=engine.device).to(engine.dtype)
        torch.cuda.synchronize()
        before = ops.launch_counts()["lut_serve"]
        out = engine.run(x)
        torch.cuda.synchronize()
        got = ops.launch_counts()["lut_serve"] - before
        check(got == b4_per_batch,
              f"{tag}: {got} B4 launches for a batch, not {b4_per_batch}")
        check(out.device.type == "cuda" and out.shape == (len(codes), engine.n_outputs),
              f"{tag}: output {tuple(out.shape)} on {out.device}")
        host = out.cpu().numpy().astype(np.int64)
        if peer is not None:
            check(np.array_equal(host, peer[k]), f"{tag}: != its peer engine at batch {k}")
        if oracle is not None:
            check(np.array_equal(host, oracle.run(codes)),
                  f"{tag}: != DaisProgram.run at batch {k}")
        outs.append(host)
    return outs


def tool_lint(tag, prog):
    from repro_torch.launch.lint import lint_program

    lines = []
    rep = lint_program(prog, name=tag, echo=lines.append)
    check(rep["ok"] and rep.get("dce_validated"), f"lint {tag}: {rep}")
    ranges = next(l for l in lines if "ranges: required_width" in l).strip()
    print(f"[tooling] lint {tag}: {len(lines)} lines ({ranges}; "
          f"{rep.get('live_entries', '-')}/{rep.get('table_entries', '-')} composed "
          f"table entries live; DCE round self-certified)")


def phase_tooling(device, jsc_layers, pid_layers):
    """Phase 11, the main path of the generic runner and the IR tooling:
    returns the engines and batches the timings use and the launch counts
    read at its end."""
    import warnings

    import torch
    from repro_torch.core.lower import compile_sequential, lower
    from repro_torch.core.rtl import verify_rtl
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve import (EnginePathWarning,
                                               EngineRequirementError)
    from repro_torch.models.pid import build_pid_graph
    from repro_torch.serve.api import EngineSpec, build

    t_phase = time.monotonic()
    prog_j = compile_sequential(jsc_layers, TRAIN_IN_F, TRAIN_IN_I)
    prog_p = lower(build_pid_graph(pid_layers, n_samples=TOOL_CTX))
    prog_1 = lower(build_pid_graph(pid_layers, n_samples=TOOL_ONE_WINDOW))
    jsc_x = {b: tool_codes(prog_j, b, TOOL_N_BATCHES, SEED + 40 + b) for b in TOOL_BATCHES}
    pid_x = {b: tool_codes(prog_p, b, TOOL_PID_N_BATCHES, SEED + 50 + b)
             for b in TOOL_PID_BATCHES}
    one_x = tool_codes(prog_1, 1024, TOOL_N_BATCHES, SEED + 60)
    pallas = dict(engine="pallas", require="pallas", verify="full", n_random=2048, seed=SEED)

    # --- the generic runner on the trained JSC-HLF program, beside B4
    gen = build(prog_j, EngineSpec(engine="groups", verify="full", n_random=2048,
                                   seed=SEED), device=device)
    check(gen.engine.path == "generic" and gen.engine.fuse_reason == "",
          f"JSC engine='groups': path {gen.engine.path} ({gen.engine.fuse_reason})")
    b4 = build(prog_j, EngineSpec(**pallas), device=device)
    b4_out = {b: tool_serve(f"JSC B4 B={b}", b4.engine, xs, 1) for b, xs in jsc_x.items()}
    for b, xs in jsc_x.items():
        tool_serve(f"JSC generic B={b}", gen.engine, xs, 0, oracle=prog_j, peer=b4_out[b])
    print(f"[tooling] JSC-HLF generic runner: {gen.engine.n_groups} op groups "
          f"({prog_j.n_instrs()} instrs), {gen.engine.dtype}, gate PASSED on "
          f"{gen.attestation['random']} random rows; {TOOL_N_BATCHES} batches x "
          f"{'/'.join(map(str, TOOL_BATCHES))} rows, each bit-exact vs DaisProgram.run "
          f"and the B4 engine, no B4 launch")

    # --- C4: the one-window pid program degrades to the generic runner
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        one = build(prog_1, EngineSpec(engine="pallas", verify="full", n_random=1024,
                                       seed=SEED), device=device)
    warned = [str(w.message) for w in caught if issubclass(w.category, EnginePathWarning)]
    check(one.engine.path == "generic" and len(warned) == 1
          and "ADD nested inside a unary chain" in one.engine.fuse_reason,
          f"pid ctx={TOOL_ONE_WINDOW}: path {one.engine.path}, warnings {warned}")
    try:
        build(prog_1, EngineSpec(engine="pallas", require="fused", verify="skip"),
              device=device)
        check(False, f"pid ctx={TOOL_ONE_WINDOW}: require='fused' did not raise")
    except EngineRequirementError as e:
        raised = str(e)
    tool_serve(f"pid ctx={TOOL_ONE_WINDOW} generic", one.engine, one_x, 0, oracle=prog_1)
    print(f"[tooling] pid ctx={TOOL_ONE_WINDOW} (C4): build(engine='pallas') warned "
          f"\"{warned[0]}\"; path {one.engine.path}, {one.engine.n_groups} op groups "
          f"({prog_1.n_instrs()} instrs), {one.engine.dtype}; gate PASSED on "
          f"{one.attestation['random']} random rows; {TOOL_N_BATCHES} batches x 1024 "
          f"bit-exact vs DaisProgram.run, no B4 launch; require='fused' raised "
          f"EngineRequirementError: {raised[:60]}...")

    # --- dead-cell elimination served through B4, gated against the oracle
    b4_p = build(prog_p, EngineSpec(**pallas), device=device)
    b4_p_out = {b: tool_serve(f"pid B4 B={b}", b4_p.engine, xs, 1)
                for b, xs in pid_x.items()}
    cases = {"jsc": (prog_j, b4, jsc_x, b4_out,
                     compile_sequential(jsc_layers, TRAIN_IN_F, TRAIN_IN_I, optimize=True)),
             f"pid ctx={TOOL_CTX}": (prog_p, b4_p, pid_x, b4_p_out,
                                     lower(build_pid_graph(pid_layers, n_samples=TOOL_CTX),
                                           optimize=True))}
    engines = {"jsc generic": (gen.engine, jsc_x), "jsc B4": (b4.engine, jsc_x),
               f"pid ctx={TOOL_ONE_WINDOW} generic": (one.engine, {1024: one_x}),
               f"pid ctx={TOOL_CTX} B4": (b4_p.engine, pid_x)}
    for tag, (prog, base, xs, base_out, lowered) in cases.items():
        dce = build(prog, EngineSpec(optimize=True, **pallas), device=device)
        check(dce.oracle is prog and dce.prog is not prog,
              f"{tag} DCE: the gate did not run against the unoptimized oracle")
        want, got = lowered.to_arrays(), dce.prog.to_arrays()
        check(want.keys() == got.keys()
              and all(np.array_equal(want[k], got[k]) for k in want),
              f"{tag} DCE: build(optimize=True) != lower(optimize=True)")
        for b, batches in xs.items():
            tool_serve(f"{tag} DCE B={b}", dce.engine, batches, 1, oracle=prog,
                       peer=base_out[b])
        n_llut = (prog.count_ops().get("LLUT", 0), dce.prog.count_ops().get("LLUT", 0))
        print(f"[tooling] {tag} DCE through B4: {dce.timings['dce_summary']}; LLUTs "
              f"{n_llut[0]} -> {n_llut[1]}; packed_table_bytes "
              f"{base.engine.packed_table_bytes} -> {dce.engine.packed_table_bytes}; "
              f"{dce.engine.dtype}; gate vs the unoptimized oracle PASSED on "
              f"{dce.attestation['random']} random rows; every batch one B4 launch, "
              f"equal to the unoptimized B4 engine")
        wide = build(prog, EngineSpec(narrow=False, **pallas), device=device)
        for b, batches in xs.items():
            tool_serve(f"{tag} narrow=False B={b}", wide.engine, batches, 1,
                       oracle=prog, peer=base_out[b])
        print(f"[tooling] {tag} narrow=False vs narrow=True through B4: dtype "
              f"{wide.engine.dtype} vs {base.engine.dtype}; packed_table_bytes "
              f"{wide.engine.packed_table_bytes} vs {base.engine.packed_table_bytes}; "
              f"bit-exact on every batch, one B4 launch each")
        t0 = time.monotonic()
        att = verify_rtl(dce.prog, oracle=prog, engine=dce.engine,
                         n_random=TOOL_RTL_ROWS, seed=SEED)
        check(att["verdict"] == "bit-exact" and att["engine_path"] == "pallas",
              f"{tag} RTL: {att}")
        print(f"[tooling] {tag} RTL three-way (RTL sim of the DCE'd program == the "
              f"unoptimized DaisProgram.run == the DCE'd B4 engine on the card): "
              f"{att['verdict']} on {att['random']} random rows; {att['n_wires']} wires, "
              f"verilog sha256 {att['verilog_sha256']} ({time.monotonic() - t0:.1f}s)")
        tool_lint(tag, prog)
        engines[f"{tag} DCE B4"] = (dce.engine, xs)
        engines[f"{tag} narrow=False B4"] = (wide.engine, xs)
    counts = ops.launch_counts()
    print(f"[tooling] phase done in {time.monotonic() - t_phase:.1f}s; ctx=3000 is not "
          f"simulated as RTL (numpy simulator: minutes of host time, no device time)")
    return engines, counts


def tooling_timings(engines):
    """For every engine of phase 11, at each batch size: the device kernels
    a call (the kernel nodes of one call captured in a CUDA graph), the
    device busy ms a batch (the summed kernel durations of a torch.profiler
    trace of ``TOOL_PROFILED_CALLS`` calls, from a trace that recorded every
    one of their kernels: a profile has been seen to drop kernel events, so
    up to ``PROFILE_TRIES`` are taken), the event span of a batch (CUDA
    events around ``TOOL_TIMED_CALLS`` calls enqueued behind a sleep; for a
    host-bound engine the host's enqueue gaps fall inside it) and the host
    ms a batch (enqueue to synchronize)."""
    import torch

    for tag, (engine, xs) in engines.items():
        for b, batches in xs.items():
            x = torch.as_tensor(batches[0], device=engine.device).to(engine.dtype)
            span = cuda_ms(lambda: engine.run(x), iters=TOOL_TIMED_CALLS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TOOL_TIMED_CALLS):
                engine.run(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / TOOL_TIMED_CALLS * 1e3
            per_call = len(graph_kernels(lambda: engine.run(x)))
            want = per_call * TOOL_PROFILED_CALLS
            busy = f"device busy ms/batch not measured (no profile recorded all {want} kernels)"
            for _ in range(PROFILE_TRIES):
                events = profile_kernels(
                    lambda: [engine.run(x) for _ in range(TOOL_PROFILED_CALLS)])
                if len(events) == want:
                    busy = (f"{sum(dur for _name, dur in events) / TOOL_PROFILED_CALLS / 1e3:.5f}"
                            f" device busy ms/batch")
                    break
                print(f"[profile] {tag} B={b}: {len(events)} of {want} kernels recorded",
                      file=sys.stderr)
            print(f"[tooling-time] {tag} B={b}: {busy}, {span:.5f} event-span ms/batch, "
                  f"{wall:.5f} host ms/batch, {per_call} device kernels a call, "
                  f"path {engine.path}, {engine.n_groups} groups")


# --------------------------------------------------------------------------- #
# Phase 12, the serving stack (serve/): bundles of the trained JSC-HLF program
# and the trained pid hybrid at ctx 100, cold-started on the card, answering
# single requests through the micro-batcher and both models through a
# 2-replica tier; B4 at every bucket of the scheduler's ladder
STACK_MAX_BATCH = 64          # launch/serve.py's --max-batch default
STACK_DELAY_MS = 2.0          # and its --max-delay-ms
STACK_JSC_REQUESTS = 1024     # and its --requests
STACK_JSC_RATES = (0.0, 2000.0)   # a burst, then its --rate
STACK_PID_REQUESTS = 256
STACK_TIER_REQUESTS = 1024
STACK_CTX = 100
STACK_TIMED = 200             # host-side samples of the per-batch breakdown


def stack_gate_launches(att) -> int:
    """B4 launches of one ``verify_engine`` gate on a B4 engine: one batch
    of random rows, and one of the exhaustive cross-product when it ran."""
    return 1 + int(att["exhaustive"] > 0)


def stack_bundles(device, progs, tmp):
    """Step 1: each program built fresh (its compose, pack, compile and gate
    times), saved, cold-started from the bundle with ``verify="cached"`` and
    ``"full"``; a copy with one table byte flipped refused.  Returns the
    bundle paths, the cold-started engines and the B4 launches the gates
    made."""
    from repro_torch.core.analysis import analyze_ranges
    from repro_torch.kernels.lut_serve import compose_fused_stages
    from repro_torch.kernels.lut_serve_cuda import pack_stages
    from repro_torch.serve.api import EngineSpec, build
    from repro_torch.serve.artifact import (ArtifactError, load_artifact,
                                            save_artifact)

    pallas = dict(engine="pallas", require="pallas", n_random=2048, seed=SEED)
    paths, engines, gates = {}, {}, 0
    for name, prog in progs.items():
        t0 = time.monotonic()
        stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
        compose_s = time.monotonic() - t0
        check(stages is not None, f"{name}: the program does not compose: {why}")
        fresh = build(prog, EngineSpec(verify="full", **pallas), device=device)
        t0 = time.monotonic()
        pack_stages(stages, fresh.engine.dtype)
        pack_s = time.monotonic() - t0
        gates += stack_gate_launches(fresh.attestation)
        paths[name] = os.path.join(tmp, f"{name}.npz")
        t0 = time.monotonic()
        digest = save_artifact(paths[name], prog, attestation=fresh.attestation)
        save_s = time.monotonic() - t0
        cached = build(paths[name], EngineSpec(verify="cached", **pallas), device=device)
        full = build(paths[name], EngineSpec(verify="full", **pallas), device=device)
        gates += stack_gate_launches(full.attestation)
        for b in (cached, full):
            check(b.content_hash == digest and b.engine.path == "pallas"
                  and b.engine.dtype == fresh.engine.dtype,
                  f"{name}: bundle {b.content_hash} ({b.engine.path}, {b.engine.dtype}) "
                  f"!= saved {digest} ({fresh.engine.dtype})")
        check(cached.attestation == fresh.attestation and "gate_s" not in cached.timings,
              f"{name}: verify='cached' did not trust the stored attestation")
        bad = os.path.join(tmp, f"{name}-tampered.npz")
        with np.load(paths[name]) as z:
            arrays = {k: z[k].copy() for k in z.files}
        key = sorted(k for k in arrays if k.startswith("packed/") and k.endswith("_table"))[0]
        arrays[key].view(np.uint8)[0] ^= 1
        np.savez(bad, **arrays)
        try:
            load_artifact(bad)
            check(False, f"{name}: a bundle with a flipped table byte was loaded")
        except ArtifactError as e:
            refused = str(e)
        check("content hash mismatch" in refused, f"{name}: tampered bundle: {refused}")
        ct, ft = cached.timings, fresh.timings
        print(f"[stack] {name} bundle: {os.path.getsize(paths[name])} bytes, hash "
              f"{digest[:12]}, saved in {save_s:.3f}s; cold start (load + compile) "
              f"{ct['load_s'] + ct['compile_s']:.4f}s ({ct['load_s']:.4f} + "
              f"{ct['compile_s']:.4f}), gate skipped (cached); verify='full' cold start "
              f"{full.timings['load_s'] + full.timings['compile_s'] + full.timings['gate_s']:.4f}s; "
              f"fresh build: compose {compose_s:.4f}s, pack {pack_s:.4f}s (both inside "
              f"compile {ft['compile_s']:.4f}s), gate {ft['gate_s']:.4f}s; {fresh.engine.dtype}, "
              f"{fresh.engine.packed_table_bytes} packed table bytes; a flipped table byte "
              f"({key}) refused: {refused[:70]}...")
        engines[name] = cached
    return paths, engines, gates


def stack_buckets(device, progs, paths):
    """Step 2: B4 from each bundle's stored packed payload at every bucket
    of the ladder, bit for bit its plain version at the engine's dtype.
    Returns the chains, the host codes of each bucket and the launches."""
    import torch
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, run_chain,
                                                    run_chain_plain)
    from repro_torch.serve.artifact import load_artifact
    from repro_torch.serve.scheduler import bucket_ladder

    chains, launches = {}, 0
    for name, prog in progs.items():
        art = load_artifact(paths[name])
        chain = PackedChain(art.packed, torch.int32, device)
        xs = {b: tool_codes(prog, b, 1, SEED + 70 + b)[0]
              for b in bucket_ladder(STACK_MAX_BATCH)}
        for b, codes in xs.items():
            x = torch.as_tensor(codes, device=device, dtype=torch.int32)
            got = run_chain(chain, x)
            launches += 1
            check(torch.equal(got, run_chain_plain(chain, x)),
                  f"{name}: B4 from the stored payload != plain at bucket {b}")
            check(np.array_equal(got.cpu().numpy().astype(np.int64), prog.run(codes)),
                  f"{name}: B4 from the stored payload != DaisProgram.run at bucket {b}")
        chains[name] = (chain, art.packed, xs)
    print(f"[stack] B4 from the bundles' stored (int64-packed) payloads on int32 "
          f"engines: bit for bit its plain version and DaisProgram.run at buckets "
          f"{bucket_ladder(STACK_MAX_BATCH)} on "
          + ", ".join(f"{n} ({c.packed.n_stages()} stages, "
                      f"{c.packed.table_bytes()} table bytes)"
                      for n, (c, _p, _x) in chains.items()))
    return chains, launches


def stack_load(progs, engines):
    """Step 3: ``compare_under_load`` (engine vs interpreter behind the
    same scheduler; it raises unless every response is bit-exact): JSC at a
    burst and at 2000 req/s, pid ctx 100 at a burst.  Returns the rows and
    the launches (the engine rows' batches and warm-ups)."""
    from repro_torch.serve.scheduler import (ServeConfig, bucket_ladder,
                                             compare_under_load)

    cfg = ServeConfig(max_batch=STACK_MAX_BATCH, max_delay_ms=STACK_DELAY_MS)
    runs = {"jsc": (STACK_JSC_REQUESTS, STACK_JSC_RATES),
            "pid": (STACK_PID_REQUESTS, (0.0,))}
    out, launches = {}, 0
    for name, (n, rates) in runs.items():
        codes = tool_codes(progs[name], n, 1, SEED + 80)[0]
        rows = compare_under_load(progs[name], engines[name].engine, codes, cfg, rates)
        for r in rows:
            if r["backend"] == "engine":
                launches += r["n_batches"] + len(bucket_ladder(STACK_MAX_BATCH))
        for rate in rates:
            eng, interp = (next(r for r in rows if r["offered_rate"] == rate
                                and r["backend"] == k) for k in ("engine", "interp"))
            offered = f"{rate:.0f} req/s" if rate > 0 else "burst"
            print(f"[stack] {name} MicroBatcher, {n} requests @ {offered} "
                  f"(achieved {eng['achieved_rate']:.1f} req/s): p50 {eng['p50_ms']:.4f} ms, "
                  f"p99 {eng['p99_ms']:.4f} ms, max {eng['max_ms']:.4f} ms, "
                  f"{eng['rows_per_s']:.1f} rows/s, {eng['n_batches']} batches, mean fill "
                  f"{eng['mean_batch_fill']:.2f}, mean bucket {eng['mean_bucket']:.2f}, pad "
                  f"overhead {eng['pad_overhead']:.4f}, warm-up {eng['warmup_s']:.4f}s; "
                  f"interpreter p50 {interp['p50_ms']:.4f} ms, p99 {interp['p99_ms']:.4f} ms, "
                  f"{interp['rows_per_s']:.1f} rows/s; engine/interpreter "
                  f"{eng['rows_per_s'] / interp['rows_per_s']:.3f}x; every response "
                  f"bit-exact vs DaisProgram.run")
            out[(name, rate)] = (eng, interp)
    return out, launches


def stack_tier(device, progs, paths, jsc_dce):
    """Step 4: ``serve()`` over both bundles, 2 replicas with stealing;
    1024 interleaved requests, each held against its own model's
    ``DaisProgram.run``; mid-load "jsc" swapped for its DCE'd engine.
    Returns the stats and the launches (batches and warm-ups)."""
    import threading

    from repro_torch.serve.api import EngineSpec, serve
    from repro_torch.serve.scheduler import ServeConfig, bucket_ladder
    from repro_torch.serve.tier import TierConfig

    spec = EngineSpec(engine="pallas", require="pallas", verify="cached")
    cfg = TierConfig(n_replicas=2, steal=True, serve=ServeConfig(
        max_batch=STACK_MAX_BATCH, max_delay_ms=STACK_DELAY_MS))
    tier = serve(paths, spec, cfg, device=device)
    try:
        # the retired engine marks its teardown; a batch it runs after that
        # would be a request served by a torn-down engine
        old = tier.registry.acquire("jsc")
        tier.registry.release(old)
        retired, late = threading.Event(), []
        runner = old.engine._runner

        def watched(x):
            if retired.is_set():
                late.append(x.shape[0])
            return runner(x)

        old.engine._runner = watched
        old.engine.close = retired.set
        per = STACK_TIER_REQUESTS // len(progs)
        rng = np.random.default_rng(SEED + 90)
        work = []
        for name, prog in progs.items():
            codes = tool_codes(prog, per, 1, SEED + 91 + len(work))[0]
            ref = prog.run(codes)
            work += [(name, codes[k], ref[k]) for k in range(per)]
        order = rng.permutation(len(work))
        t0 = time.monotonic()
        flights = []
        for k, idx in enumerate(order):
            if k == len(order) // 2:
                check(tier.registry.swap("jsc", jsc_dce.engine, jsc_dce.prog) == 2,
                      "the hot-swap did not publish version 2")
            name, row, ref = work[idx]
            flights.append((tier.submit(row, name), name, ref))
        bad = sum(not np.array_equal(np.asarray(f.result(timeout=120), np.int64), ref)
                  for f, _n, ref in flights)
        wall = time.monotonic() - t0
        s = tier.stats()
    finally:
        tier.stop()
    check(bad == 0, f"tier: {bad} responses differ from their model's DaisProgram.run")
    check(retired.is_set() and not late and tier.registry.draining() == 0,
          f"tier: retired engine torn down {retired.is_set()}, batches after it {late}")
    check(s.per_model == {name: per for name in progs},
          f"tier: per-model counts {s.per_model}")
    print(f"[stack] tier: 2 replicas (time-multiplexed on one card), stealing; "
          f"{len(flights)} interleaved requests as a burst in {wall:.4f}s "
          f"({len(flights) / wall:.1f} req/s): p50 {s.p50_ms:.4f} ms, p99 "
          f"{s.p99_ms:.4f} ms, max {s.max_ms:.4f} ms; per model {s.per_model}; "
          f"{s.n_batches} batches (per replica {list(s.per_replica_batches)}), mean fill "
          f"{s.mean_batch_fill:.2f}, pad overhead {s.pad_overhead:.4f}; stolen "
          f"{s.n_stolen}; mid-load hot-swap of jsc for its DCE'd engine: no request "
          f"failed, the retired engine drained and ran no batch after its teardown; "
          f"every response bit-exact vs its model's DaisProgram.run")
    return s, s.n_batches + len(progs) * len(bucket_ladder(STACK_MAX_BATCH))


def phase_stack(device, jsc_layers, pid_layers):
    """Phase 12, the main path of the serving stack: returns what the
    timings use and the launch counts read at its end."""
    import shutil
    import tempfile

    from repro_torch.core.lower import compile_sequential, lower
    from repro_torch.kernels import ops
    from repro_torch.models.pid import build_pid_graph
    from repro_torch.serve.api import EngineSpec, build

    t_phase = time.monotonic()
    progs = {"jsc": compile_sequential(jsc_layers, TRAIN_IN_F, TRAIN_IN_I),
             "pid": lower(build_pid_graph(pid_layers, n_samples=STACK_CTX))}
    tmp = tempfile.mkdtemp(prefix="stack-")
    try:
        paths, engines, gates = stack_bundles(device, progs, tmp)
        jsc_dce = build(progs["jsc"], EngineSpec(engine="pallas", require="pallas",
                                                 optimize=True, verify="full",
                                                 n_random=2048, seed=SEED), device=device)
        gates += stack_gate_launches(jsc_dce.attestation)
        chains, bucket_launches = stack_buckets(device, progs, paths)
        load, load_launches = stack_load(progs, engines)
        tier, tier_launches = stack_tier(device, progs, paths, jsc_dce)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ops.launch_counts()
    want = gates + bucket_launches + load_launches + tier_launches
    check(counts["lut_serve"] == want
          and all(n == 0 for k, n in counts.items() if k != "lut_serve"),
          f"stack: launches {counts}, B4 expected {want} (gates {gates}, buckets "
          f"{bucket_launches}, MicroBatcher batches + warm-ups {load_launches}, tier "
          f"batches + warm-ups {tier_launches})")
    print(f"[stack] B4 launches {counts['lut_serve']} = gates {gates} + stored-payload "
          f"buckets {bucket_launches} + MicroBatcher batches and warm-ups "
          f"{load_launches} + tier batches and warm-ups {tier_launches}: every request "
          f"batch reached the kernel, nothing ran a plain version; phase done in "
          f"{time.monotonic() - t_phase:.1f}s")
    return {"progs": progs, "engines": engines, "chains": chains, "load": load,
            "tier": tier}, counts


def stack_timings(stack, report):
    """After the phase's launch count: B4 at every bucket of both chains
    (CUDA events, beside its bound), then where one request batch's host
    time goes on the JSC engine at buckets 1 and 64: stacking and padding
    the codes, ``engine.run`` (the host-to-device copy, the dtype cast and
    B4's enqueue) and the ``.cpu()`` that waits for the result (medians of
    ``STACK_TIMED`` batches); last, the scheduler alone: the JSC burst of
    step 3 through a ``MicroBatcher`` whose engine is a host copy of its
    input (no device work), the queueing and scatter the burst pays on its
    own."""
    import torch
    from repro_torch.kernels.lut_serve_cuda import run_chain
    from repro_torch.parallel.sharding import pad_batch
    from repro_torch.serve.scheduler import (MicroBatcher, ServeConfig,
                                             drive_open_loop)

    times, bounds = {}, {}
    for name, (chain, packed, xs) in stack["chains"].items():
        times[name], bounds[name] = {}, {}
        for b, codes in xs.items():
            x = torch.as_tensor(codes, device=chain.device, dtype=torch.int32)
            times[name][b] = cuda_ms(lambda: run_chain(chain, x), iters=50)
            bounds[name][b] = b4_bound(chain, packed, b)[0]
        print(f"[stack-time] B4 {name} by bucket, ms (bound): " + ", ".join(
            f"{b}: {times[name][b]:.5f} ({bounds[name][b]:.6f})" for b in xs))
    engine = stack["engines"]["jsc"].engine
    for b in (1, STACK_MAX_BATCH):
        rows = stack["chains"]["jsc"][2][b]
        pad_s, run_s, cpu_s = [], [], []
        for _ in range(STACK_TIMED):
            t0 = time.perf_counter()
            x = pad_batch(np.stack(list(rows[:max(b - 1, 1)])), b)
            t1 = time.perf_counter()
            out = engine.run(x)
            t2 = time.perf_counter()
            out[:b].cpu().numpy()
            t3 = time.perf_counter()
            pad_s.append(t1 - t0)
            run_s.append(t2 - t1)
            cpu_s.append(t3 - t2)
        med = [float(np.median(v)) * 1e3 for v in (pad_s, run_s, cpu_s)]
        print(f"[stack-time] jsc request batch, bucket {b}: host ms (median of "
              f"{STACK_TIMED}) stack + pad {med[0]:.5f}, engine.run (copy in, cast, B4 "
              f"enqueue) {med[1]:.5f}, .cpu() (wait + copy out) {med[2]:.5f}; B4 device "
              f"{times['jsc'][b]:.5f}")
    class HostCopy:
        n_inputs = engine.n_inputs

        def run(self, x):
            return np.array(x)

    codes = tool_codes(stack["progs"]["jsc"], STACK_JSC_REQUESTS, 1, SEED + 80)[0]
    with MicroBatcher(HostCopy(), ServeConfig(max_batch=STACK_MAX_BATCH,
                                              max_delay_ms=STACK_DELAY_MS)) as mb:
        out, drive = drive_open_loop(mb, codes, 0.0)
    check(np.array_equal(out, codes), "scheduler alone: rows came back misrouted")
    s = mb.stats()
    print(f"[stack-time] scheduler alone (host-copy engine), {STACK_JSC_REQUESTS} "
          f"requests as a burst: p50 {s.p50_ms:.4f} ms, p99 {s.p99_ms:.4f} ms, "
          f"{STACK_JSC_REQUESTS / drive['wall_s']:.1f} rows/s, {s.n_batches} batches, "
          f"submitted at {drive['achieved_rate']:.1f} req/s")
    report["lut_serve"].update({
        "stack_bucket_ms": times, "stack_bucket_bound_ms": bounds})


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


def wide_chain(rng, dtype):
    """A seeded packed chain whose constants and first stage's tables do not
    fit a block's shared memory beside its tile buffers (900-wide rows):
    the kernel reads both from global memory, and stages only the second
    stage's tables; in int64 a tile holds fewer than 32 rows."""
    import torch
    from repro_torch.kernels.lut_serve_cuda import PackedStage, PackedStages

    ed = np.int32 if dtype == torch.int32 else np.int64
    n_in, j1, c1, j2, c2 = 900, 900, 64, 64, 3
    st1 = PackedStage(
        "lut", np.arange(n_in, dtype=np.int64)[None], n_in,
        rng.integers(-40, 40, (1, c1)).astype(ed), [], in_shift=None,
        mask=np.full((j1, c1), 3, np.int64),
        table=rng.integers(-128, 128, (j1, c1, 4)).astype(np.int8))
    st2 = PackedStage(
        "lut", np.arange(c1, dtype=np.int64)[None], c1,
        rng.integers(-9, 9, (1, c2)).astype(ed), [], in_shift=None,
        mask=np.full((j2, c2), 15, np.int64),
        table=rng.integers(-2 ** 12, 2 ** 12, (j2, c2, 16)).astype(np.int16))
    return PackedStages([st1, st2], out_cols=np.asarray([2, 0, 1], np.int64), n_cols0=n_in)


def phase_synthetic(device):
    """B4 on what JSC-HLF does not cover, bit for bit against its plain
    version: the seeded synthetic chain, the wide chain (constants and one
    stage's tables in global memory, tiles of fewer than 32 rows in int64),
    in int32 and int64 compute; and a 16->64->5 stack served through the
    gate, whose first stage's tables read global memory and second stage's
    shared memory in one launch."""
    import torch
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels.lut_serve_cuda import PackedChain, run_chain, run_chain_plain
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.serve.api import EngineSpec, build

    rng = np.random.default_rng(SEED + 3)
    for make, b in ((synthetic_chain, 4099), (wide_chain, 1031)):
        for dtype in (torch.int32, torch.int64):
            packed = make(rng, dtype)
            chain = PackedChain(packed, dtype, device)
            x = torch.as_tensor(rng.integers(-2 ** 10, 2 ** 10, (b, packed.n_cols0)),
                                device=device).to(dtype)
            got = run_chain(chain, x)
            again = run_chain(chain, x)
            torch.cuda.synchronize()
            want = run_chain_plain(chain, x)
            check(torch.equal(got, want) and torch.equal(got, again),
                  f"B4 != plain on the {make.__name__} {dtype}")
            lanes = sorted({str(st.table.dtype) for st in packed.stages
                            if st.table is not None})
            print(f"[synthetic] {make.__name__} {dtype} compute, lanes {lanes}, B={b}: "
                  f"{len(packed.stages)} stages bit-exact vs the plain chain, two launches "
                  f"alike; plan: {b4_plan_text(chain, (b,))}")
    layers = build_lut_stack([16, 64, 5], HIDDEN, device=device,
                             generator=torch.Generator().manual_seed(SEED + 13))
    prog = compile_sequential(layers, IN_F, IN_I)
    built = build(prog, EngineSpec(engine="pallas", require="pallas", verify="full",
                                   n_random=2048, seed=SEED), device=device)
    chain, packed = plain_chain(prog, built.engine, device)
    check(chain.plan.table_soff[0] < 0 <= chain.plan.table_soff[1],
          f"16->64->5: expected stage 0 global and stage 1 shared, got {chain.plan}")
    x = b4_codes(prog, np.random.default_rng(SEED + 14), 4099, built.engine.dtype, device)
    out = built.engine.run(x)
    torch.cuda.synchronize()
    check(torch.equal(out, run_chain_plain(chain, x)), "16->64->5: B4 != the plain chain")
    check(np.array_equal(out.cpu().numpy().astype(np.int64),
                         prog.run(x.cpu().numpy().astype(np.int64))),
          "16->64->5: served batch != DaisProgram.run")
    print(f"[synthetic] 16->64->5 stack ({packed.table_bytes()} table bytes): gate PASSED "
          f"on path {built.engine.path}; B=4099 served bit-exact vs the plain chain and "
          f"DaisProgram.run; plan: {b4_plan_text(chain, (4099,))}")


def main_b1_timing() -> int:
    """``--b1-timing``: only B1's cold-L2 timings (the same harness for two
    trees, run from each tree's root); prints no result line."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_fused

    phase_device()
    b1_timings(torch.device("cuda:0"), fake_quant_fused,
               np.random.default_rng(SEED + 6), tag=f" {os.path.basename(REPO)}")
    return 0


def main_b2_timing() -> int:
    """``--b2-timing``: only B2's timings at the JSC-HLF shapes, with its
    registers and SASS (the same harness for two trees, run from each
    tree's root); prints no result line."""
    import torch
    from repro_torch.kernels.lut_dense import lut_dense_fused

    phase_device()
    tag = f" {os.path.basename(REPO)}"
    kern = b2_kernel()
    print(f"[B2{tag}] ptxas, H={HIDDEN}: {ptxas_usage('lut_dense', kern)}")
    sass, per_row = sass_hot_loop("lut_dense", kern, HIDDEN)
    print(f"[B2{tag}] SASS, H={HIDDEN}: {sass}")
    b2_timings(lut_dense_fused, torch.device("cuda:0"), tag=tag, per_row=per_row)
    return 0


def main_b3_timing() -> int:
    """``--b3-timing``: only B3's timings at the JSC-HLF shapes, with its
    registers and SASS (the same harness for two trees, run from each
    tree's root); prints no result line."""
    import torch
    from repro_torch.kernels.lut_dense_bwd import lut_dense_bwd_fused

    phase_device()
    tag = f" {os.path.basename(REPO)}"
    print(f"[B3{tag}] ptxas, H={HIDDEN}: {ptxas_usage('lut_dense_bwd', B3_KERNEL)}")
    sass, per_row = sass_hot_loop("lut_dense_bwd", B3_KERNEL, HIDDEN)
    print(f"[B3{tag}] SASS, H={HIDDEN}: {sass}")
    b3_timings(lut_dense_bwd_fused, torch.device("cuda:0"), tag=tag, per_row=per_row)
    return 0


def main_b4_timing() -> int:
    """``--b4-timing``: only B4's timings on the JSC-HLF chain (int32, as
    served) at B in ``B4_TIMING_BATCHES``, with its registers, launch plan
    and bound, and the fixed cost and cost per row of a line through the
    device times (the same harness for two trees, run from each tree's
    root); prints no result line."""
    import torch
    from repro_torch.core.analysis import analyze_ranges
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels.lut_serve import compose_fused_stages
    from repro_torch.kernels.lut_serve_cuda import (PackedChain, pack_stages, run_chain,
                                                    run_chain_plain)
    from repro_torch.launch.serve import build_lut_stack

    phase_device()
    tag = f" {os.path.basename(REPO)}"
    device = torch.device("cuda:0")
    for func, usage in ptxas_entries("lut_serve"):
        print(f"[B4{tag}] ptxas {func}: {usage}")
    layers = build_lut_stack(list(JSC_DIMS), HIDDEN, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    prog = compile_sequential(layers, IN_F, IN_I)
    stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    check(stages is not None, why)
    packed = pack_stages(stages, torch.int32)
    chain = PackedChain(packed, torch.int32, device)
    print(f"[B4{tag}] plan: {b4_plan_text(chain, B4_TIMING_BATCHES)}")
    rng = np.random.default_rng(SEED + 15)
    times = []
    for b in B4_TIMING_BATCHES:
        x = b4_codes(prog, rng, b, torch.int32, device)
        check(torch.equal(run_chain(chain, x), run_chain_plain(chain, x)),
              f"B4 != plain chain at B={b}")
        ms = cuda_ms(lambda: run_chain(chain, x), iters=50)
        busy = host_us(lambda: run_chain(chain, x), busy=True)
        idle = host_us(lambda: run_chain(chain, x), busy=False)
        b_ms, b_by = b4_bound(chain, packed, b)
        times.append(ms)
        print(f"[B4{tag}] JSC-HLF chain B={b}: device {ms:.5f} ms a call (CUDA events, "
              f"host ahead); host {busy[0]:.2f} us a call median, {busy[1]:.2f} mean "
              f"(enqueue only, 1000 calls, device busy), {idle[0]:.2f} median, "
              f"{idle[1]:.2f} mean (device idle between calls); bound {b_ms:.5f} ms "
              f"({b_by})")
    slope, fixed = np.polyfit(np.asarray(B4_TIMING_BATCHES, float), times, 1)
    print(f"[B4{tag}] line through the device times: {fixed * 1e3:.2f} us fixed (launch "
          f"and staging), {slope * 1e6:.3f} ns a row")
    return 0


def main_loop_timing() -> int:
    """``--loop-timing``: only the chunked loop's timings and profiles (the
    same harness for two trees, run from each tree's root); prints no result
    line."""
    import torch

    phase_device()
    loop_timings(torch.device("cuda:0"), tag=f" {os.path.basename(REPO)}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--b1-timing"]:
        return main_b1_timing()
    if sys.argv[1:] == ["--b2-timing"]:
        return main_b2_timing()
    if sys.argv[1:] == ["--b3-timing"]:
        return main_b3_timing()
    if sys.argv[1:] == ["--b4-timing"]:
        return main_b4_timing()
    # reference precision: no float32 matmul or convolution rounds via TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--loop-timing"]:
        return main_loop_timing()
    from repro_torch.kernels import ops

    device = torch.device("cuda:0")
    report = {}
    paths = {"serve": ("lut_dense", "lut_serve"),
             "train": ("fake_quant", "lut_dense", "lut_dense_bwd", "lut_serve"),
             "loop": ("fake_quant", "lut_dense", "lut_dense_bwd", "lut_serve"),
             "pid": ("fake_quant", "lut_serve"),
             "tooling": ("lut_serve",),
             "stack": ("lut_serve",)}
    launches = {}
    try:
        phase_device()
        phase_b1(device, report)
        phase_b2(device, report)
        phase_b3(device, report)
        phase_c10(device)
        ops.reset_launch_counts()                      # path 1: serve
        prog = phase_slice_float(device)
        chain, xs, packed, b4_err = phase_slice_serve(device, prog)
        launches["serve"] = ops.launch_counts()
        # B4 against its plain version and timed, off the main path and before
        # the train path's torch.profiler window (a profile taken after it in
        # the same process has recorded no device kernel)
        phase_b4(device, prog, chain, xs, packed, b4_err, report)
        train_state = phase_train(device)
        ops.reset_launch_counts()                      # path 2: train, then serve
        train = phase_train_run(device, *train_state)
        launches["train"] = ops.launch_counts()
        ops.reset_launch_counts()                      # path 3: the chunked loop
        phase_loop(device)
        launches["loop"] = ops.launch_counts()
        loop = loop_timings(device)
        pid_layers, pid_data, pid_cpu = phase_pid(device)
        ops.reset_launch_counts()                      # path 4: the pid hybrid
        pid = phase_pid_run(device, pid_layers, pid_data, pid_cpu)
        launches["pid"] = ops.launch_counts()
        phase_pid_b1(device, report)
        phase_pid_fused(device, pid_layers, pid_data)
        phase_pid_b4(device, pid["served"], report)
        ops.reset_launch_counts()                      # path 5: generic runner, IR tooling
        tool_engines, launches["tooling"] = phase_tooling(device, train_state[0], pid_layers)
        tooling_timings(tool_engines)
        ops.reset_launch_counts()                      # path 6: the serving stack
        stack, launches["stack"] = phase_stack(device, train_state[0], pid_layers)
        stack_timings(stack, report)
        for path, names in paths.items():
            check(all(launches[path][n] > 0 for n in names),
                  f"the {path} path skipped a kernel: launches {launches[path]}")
            print(f"[main-path] {path}: kernel launches {launches[path]}")
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
    print("[loop] summary, steady ms/step (device idle share): " + "; ".join(
        f"{name} {v['steady']:.4f} ({v['idle']:.3f})" for name, v in loop.items()))
    print(f"[pid] summary: {pid['ms_step']:.4f} device ms/step, {pid['host_ms_step']:.4f} "
          f"host ms/step, {pid['steps_per_s']:.2f} steps/s at B={PID_BATCH} x "
          f"{PID_WF_LEN} samples; separation {pid['sep']:.4f} (truth {pid['sep_true']:.4f}); "
          + "; ".join(f"ctx={c}: {v['n_instrs']} instrs" for c, v in pid["served"].items()))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
