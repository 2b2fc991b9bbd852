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
3. kernel B2 (LUT-Dense forward) against its plain version at the JSC-HLF
   layer shapes 16->20 and 20->5, H=8, B=16600: code flips counted and
   bounded, both timed with CUDA events;
4. kernel B3 (recompute backward) against its plain version at the same
   shapes with pruned cells, and one cell at a time at the edge widths f =
   +-127, i = -127, within ``B3_REL``; two launches bitwise equal; one
   device kernel a call (profiler); no register spills at H = 8 (ptxas);
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
   the plain versions (on the CPU, where the wrappers take them); the Adam
   step counter on the card, and beta and lr from it against the CPU's, in
   ulps; a finite, falling loss; then the trained model evaluated, lowered (eval forward ==
   ``run_float`` exactly) and served through B4 behind the gate;
8. a seeded synthetic packed chain covering what JSC-HLF does not (sum
   stages, non-identity gathers with the zero column, in-shifts, CMUL and
   WRAP epilogues, int8/int16/int32/int64 lanes, int32 and int64 compute),
   kernel B4 against its plain version bit for bit;
9. the ``kernels`` JSON line, then the result line.

``python3 chip_smoke.py --b1-timing`` and ``--b3-timing`` print only kernel
B1's or B3's timings (and B3's registers and SASS), and no result line, to
compare two trees in one call.

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
    import torch
    from repro_torch.core.quant import _fq_forward
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fake_quant_ref

    cases = b1_cases(np.random.default_rng(SEED + 4), device)
    for label, x, f, i, signed, overflow in cases:
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


def device_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs (torch.profiler)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def ptxas_usage(name: str, kernel) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of the kernel whose
    mangled name contains every string of ``kernel``, from the last build
    of ``name``."""
    from repro_torch.kernels import build as kbuild

    lines = kbuild.build_log(name).splitlines()
    for k, ln in enumerate(lines):
        if "Compiling entry function" in ln and all(s in ln for s in kernel):
            got = []
            for nxt in lines[k + 1:]:
                if "Compiling entry function" in nxt:
                    break
                if "spill" in nxt or "Used" in nxt:
                    got.append(nxt.split(" : ", 1)[-1].strip())
            return "; ".join(got)
    return "not in the build log"


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
    tanh (``TANH_MARK``, ``hidden`` of them a (b, j, o)), with its
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
                loops.append((k + 1 - tgt, n_tanh, sum("SHFL" in o for o in body),
                              sum("MUFU" in o for o in body)))
    if not loops:
        return f"{len(ins)} instructions; no loop evaluates a row of tanh", None
    n, n_tanh, n_shfl, n_mufu = min(loops)
    rows = n_tanh / hidden
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
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_serve_cuda import run_chain_plain
    from repro_torch.serve.api import EngineSpec, build
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


def main_b1_timing() -> int:
    """``--b1-timing``: only B1's cold-L2 timings (the same harness for two
    trees, run from each tree's root); prints no result line."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant_fused

    phase_device()
    b1_timings(torch.device("cuda:0"), fake_quant_fused,
               np.random.default_rng(SEED + 6), tag=f" {os.path.basename(REPO)}")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--b1-timing"]:
        return main_b1_timing()
    if sys.argv[1:] == ["--b3-timing"]:
        return main_b3_timing()
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
