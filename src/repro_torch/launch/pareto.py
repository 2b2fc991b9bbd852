"""β trade-off Pareto sweep: ONE training run → a served operating point
(port of ``repro.launch.pareto``).

The paper's headline methodological claim (§III-B, §V-A) is that a single
β-ramped training run with element-wise zero-bit pruning replaces manual
bit-width tuning: snapshots taken along the exponential β ramp trace the
accuracy↔resource frontier without per-point retraining.  This launcher is
that claim as one command, end to end through the *hardware* pipeline:

1. **train once** — the quickstart JSC-HLF LUT-Dense stack under the
   CE + β(step)·EBOPs objective (``train/steps.make_lut_train_step``, the
   einsum path: kernel B1 on the card), with β ramping ``--beta-init`` →
   ``--beta-final`` (defaults: the paper's 5e-7 → 1e-3), in chunks of
   ``--chunk-steps`` (``train/loop.chunked_train``: one CUDA graph per
   distinct chunk length on the card) that never cross a snapshot, each
   snapshot checkpointed by ``ckpt/store``;
2. **compile every snapshot** — restore it into a copy of the stack,
   measure accuracy (eval forward), extract truth tables, lower to DAIS,
   run the dead-cell elimination pass (``core/opt.py``), build the serving
   engine (``--engine pallas``: kernel B4) and gate it bit-exactly against
   the *unoptimized* interpreter (``verify_engine``);
3. **report the frontier** — per snapshot: accuracy, EBOPs, estimated FPGA
   LUTs, live-LUT count (post-DCE LLUT instructions), gather width before
   and after DCE, proven widths, live table entries and the engine's host
   wall time a batch — printed as a table and written to ``--out``;
4. **select + serve** — pick the cheapest frontier point within
   ``--select-tol`` of the best validation accuracy, optionally attest its
   Verilog three ways (``--verify-rtl``), persist it as a bundle whose
   attestation records the snapshot's β / EBOPs / gate statistics
   (``serve/artifact.py``), cold-start it, and serve requests through a
   2-replica ``ServeTier``, every response held against
   ``DaisProgram.run``.

The flags, defaults, validation messages and JSON keys are the reference's,
plus ``--device`` (default ``cuda``).  One difference: the default
``--out`` is ``results/pareto.json`` (a git-ignored directory), where the
reference's default overwrites the committed ``BENCH_pareto.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.pareto                   # full sweep
    PYTHONPATH=src python -m repro_torch.launch.pareto --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.pareto --engine pallas --verify-rtl
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch

IN_F, IN_I = 4, 3     # quickstart/JSC input grid


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale CI run: few steps, small data, "
                         "same train -> snapshot -> compile -> serve path")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--snapshots", type=int, default=None,
                    help="checkpoints taken along the ramp (>= 3)")
    ap.add_argument("--beta-init", type=float, default=5e-7)
    ap.add_argument("--beta-final", type=float, default=1e-3,
                    help="paper §V-A HLF JSC ramp endpoint")
    ap.add_argument("--dims", default="16,20,5",
                    help="LUT-Dense stack widths (in,...,out)")
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="snapshot directory (default: a fresh temp dir)")
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="optimizer steps per chunk in the β-ramped training "
                         "run (train/loop.py: one CUDA graph per distinct "
                         "chunk length on the card); chunks never cross "
                         "snapshot boundaries")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="synthesize training batches synchronously instead "
                         "of on the background prefetch thread")
    ap.add_argument("--out", default=os.path.join("results", "pareto.json"),
                    help="frontier JSON output path (default "
                         "results/pareto.json, git-ignored; the committed "
                         "BENCH_pareto.json is the reference's)")
    ap.add_argument("--select-tol", type=float, default=0.02,
                    help="serve the cheapest point within this much "
                         "validation accuracy of the best snapshot")
    ap.add_argument("--serve-requests", type=int, default=None,
                    help="requests pushed through the tier for the "
                         "selected operating point (0 disables serving)")
    ap.add_argument("--engine", choices=("fused", "pallas"), default="fused",
                    help="serving engine for the per-snapshot latency "
                         "columns and the served operating point: fused "
                         "per-stage PyTorch integer ops (default) or the "
                         "one-launch packed chain (kernel B4)")
    ap.add_argument("--verify-rtl", action="store_true",
                    help="before bundling the selected operating point, "
                         "emit its (DCE'd) Verilog and assert the three-way "
                         "attestation RTL sim == unoptimized interpreter == "
                         "engine (core/rtl.verify_rtl); the bundle's "
                         "attestation gains an 'rtl' entry with the Verilog "
                         "SHA-256 and verdict")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap


@dataclasses.dataclass(frozen=True)
class Settings:
    """The sweep's sizes, resolved from the flags and ``--smoke``."""

    steps: int
    batch: int
    n_snap: int
    n_train: int
    n_eval: int
    bench_batch: int
    bench_rounds: int
    n_requests: int
    n_gate: int             # random rows of every gate (engine and RTL)
    max_batch: int          # the tier's micro-batch bound
    dims: Tuple[int, ...]


def resolve_settings(args) -> Settings:
    """The reference's defaults and validation (``SystemExit`` with its
    messages); no falsy-``or`` fallbacks: an explicit 0 errors."""
    from repro_torch.core.ebops import beta_ramp_error

    steps = args.steps if args.steps is not None else (60 if args.smoke else 1500)
    batch = args.batch if args.batch is not None else (256 if args.smoke else 1024)
    n_snap = args.snapshots if args.snapshots is not None else \
        (3 if args.smoke else 8)
    if steps <= 0 or batch <= 0:
        raise SystemExit(f"--steps {steps} / --batch {batch}: both must "
                         f"be positive")
    if args.chunk_steps < 1:
        raise SystemExit(f"--chunk-steps {args.chunk_steps}: must be >= 1")
    err = beta_ramp_error(args.beta_init, args.beta_final)
    if err:
        raise SystemExit(f"--beta-init/--beta-final: {err}")
    if n_snap < 3:
        raise SystemExit(f"--snapshots {n_snap}: the frontier needs at "
                         f"least 3 operating points")
    if steps < n_snap:
        raise SystemExit(
            f"--steps {steps} cannot fit {n_snap} distinct snapshots; "
            f"raise --steps or lower --snapshots")
    n_train, n_eval = (2000, 500) if args.smoke else (20000, 5000)
    n_requests = args.serve_requests
    if n_requests is None:
        n_requests = 96 if args.smoke else 1024
    dims = tuple(int(d) for d in args.dims.split(","))
    if len(dims) < 2:
        raise SystemExit("--dims needs at least in,out (e.g. 16,5)")
    return Settings(steps=steps, batch=batch, n_snap=n_snap, n_train=n_train,
                    n_eval=n_eval, bench_batch=128 if args.smoke else 1024,
                    bench_rounds=3 if args.smoke else 15, n_requests=n_requests,
                    n_gate=256 if args.smoke else 1024,
                    max_batch=16 if args.smoke else 64, dims=dims)


def _quantize(x: np.ndarray) -> np.ndarray:
    """Inputs on the f=4, i=3 grid, as float32 (exact on that grid)."""
    from repro_torch.core.quant import int_to_float, quantize_to_int

    return int_to_float(quantize_to_int(x, IN_F, IN_I, True, "SAT"), IN_F).astype(np.float32)


def _snapshot_steps(steps: int, n: int):
    """n distinct checkpoint steps, evenly spaced, ending at ``steps``."""
    raw = [max(1, round(steps * (k + 1) / n)) for k in range(n)]
    return sorted(set(raw))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_engine(engine, prog, batch: int, rounds: int, seed: int) -> dict:
    """Median-free best-of-N engine host wall time on random in-range codes
    (the device synchronized around every call)."""
    from repro_torch.kernels.lut_serve import input_code_bounds

    lo, hi = input_code_bounds(prog)
    rng = np.random.default_rng(seed)
    codes = torch.as_tensor(rng.integers(lo, hi + 1, (batch, len(lo)), np.int64),
                            device=engine.device).to(engine.dtype)
    engine._runner(codes)                               # warm
    _sync(engine.device)
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        engine._runner(codes)
        _sync(engine.device)
        best = min(best, time.perf_counter() - t0)
    return {"engine_us": best * 1e6, "rows_per_s": batch / best}


def _plain(obj):
    """``obj`` with numpy scalars and arrays as Python numbers and lists, so
    ``json.dump`` writes what the reference writes; a tensor is an error."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        raise TypeError("a tensor reached the Pareto payload")
    if isinstance(obj, (np.generic, np.ndarray)):
        return obj.tolist()
    return obj


def evaluate(layers, x: torch.Tensor, y: torch.Tensor) -> float:
    """Accuracy of the stack's eval forward (float32 mean, as the reference)."""
    with torch.no_grad():
        h = x
        for layer in layers:
            h, _ = layer(h)
        return float(torch.mean((torch.argmax(h, -1) == y).to(torch.float32)))


def measure_point(layers, *, step: int, beta: float, val, test, engine: str,
                  n_gate: int, bench_batch: int, bench_rounds: int,
                  seed: int) -> Tuple[dict, tuple]:
    """One snapshot through the hardware pipeline.

    ``layers`` is the snapshot's stack in eval mode; ``val`` and ``test``
    are ``(x, y)`` tensors on its device.  Returns the frontier record (the
    reference's keys; ``on_frontier`` comes from :func:`select_frontier`)
    and ``(opt_prog, gate, prog, engine)``: the DCE'd program, the gate's
    statistics, the unoptimized program and the engine.
    """
    from repro_torch.core.analysis import analyze_ranges
    from repro_torch.core.ebops import ebops_lut_np, estimate_luts
    from repro_torch.core.lower import compile_sequential
    from repro_torch.core.opt import eliminate_dead_cells
    from repro_torch.core.tables import extract_tables
    from repro_torch.kernels.lut_serve import compile_program, verify_engine
    from repro_torch.launch.lint import live_table_stats

    device = next(layers[0].parameters()).device
    val_acc = evaluate(layers, *val)
    test_acc = evaluate(layers, *test)
    tables = [extract_tables(layer) for layer in layers]
    ebops = float(sum(ebops_lut_np(t.in_width, t.out_width) for t in tables))
    prog = compile_sequential(layers, IN_F, IN_I)
    opt_prog, rep = eliminate_dead_cells(prog)
    eng = compile_program(opt_prog, device=device, engine=engine)
    gate = verify_engine(eng, prog, n_random=n_gate, seed=seed)
    bench = _bench_engine(eng, opt_prog, bench_batch, bench_rounds, seed)
    gw0, gw1 = rep.total_gather_width()
    # static-analysis stats (core/analysis.py): proven vs required widths
    # and the live fraction of composed table entries
    ranges = analyze_ranges(opt_prog)
    live = live_table_stats(opt_prog, ranges) or {}
    point = _plain({
        "step": step, "beta": beta,
        "val_acc": val_acc, "test_acc": test_acc,
        "ebops": ebops, "est_luts": estimate_luts(ebops),
        "n_llut": rep.n_llut_before, "n_llut_live": rep.n_llut_after,
        "gather_width": gw0, "gather_width_dce": gw1,
        "n_instrs": rep.n_instrs_before,
        "n_instrs_dce": rep.n_instrs_after,
        "engine_path": eng.path,
        "packed_table_bytes": eng.packed_table_bytes,
        "required_width": opt_prog.required_width(),
        "proven_width": ranges.proven_width(),
        "engine_width": ranges.engine_width(),
        **live,
        "bench_batch": bench_batch, **bench,
        "verify": gate,
    })
    return point, (opt_prog, gate, prog, eng)


def select_frontier(points: List[dict], select_tol: float):
    """Mark ``on_frontier`` on every point (cheapest first, a point is on
    the frontier when it beats every cheaper point's validation accuracy);
    returns ``(frontier, top, selected)``: the cheapest frontier point
    within ``select_tol`` of the best validation accuracy is selected."""
    by_cost = sorted(points, key=lambda p: (p["est_luts"], -p["val_acc"]))
    best_acc = -1.0
    for p in by_cost:
        p["on_frontier"] = p["val_acc"] > best_acc
        best_acc = max(best_acc, p["val_acc"])
    frontier = [p for p in by_cost if p["on_frontier"]]
    top = max(points, key=lambda p: p["val_acc"])
    selected = next(p for p in frontier
                    if p["val_acc"] >= top["val_acc"] - select_tol)
    return frontier, top, selected


def beta_used(beta, step: int, device) -> float:
    """The float32 β of step ``step``: the schedule evaluated on the step
    counter's device, as the train step evaluates it."""
    return float(beta(torch.tensor(step, dtype=torch.int32, device=device)))


def train_snapshots(step_fn, layers, opt_state, get_batch, steps: int, snap_steps,
                    *, store, beta, chunk_steps: int,
                    prefetch: bool) -> Tuple[List[tuple], dict]:
    """Train ``layers`` over steps ``[0, steps)`` through ``chunked_train``,
    saving a checkpoint with its β (``{"beta", "step"}`` in the manifest) at
    every step of ``snap_steps``; no chunk crosses one.  Returns one
    ``(step, k, dt_s, host_s, compiled)`` a chunk and the Adam state after
    the last.  A non-finite loss raises."""
    from repro_torch.train.loop import chunked_train
    from repro_torch.train.steps import named_params

    params = named_params(layers)
    device = next(iter(params.values())).device
    snap_set = set(snap_steps)
    chunks = []
    for res in chunked_train(step_fn, params, opt_state, get_batch, 0, steps,
                             chunk_steps=chunk_steps, boundaries=snap_steps,
                             prefetch=prefetch):
        chunks.append((res.step, res.k, res.dt_s, res.host_s, res.compiled))
        opt_state = res.opt_state
        losses = res.metrics["loss"]
        if not np.all(np.isfinite(losses)):
            bad = res.step + int(np.argmin(np.isfinite(losses)))
            raise RuntimeError(f"non-finite loss at step {bad}: "
                               f"{losses[bad - res.step]} — β ramp broken?")
        end = res.step + res.k
        if end in snap_set:
            b = beta_used(beta, end - 1, device)
            # blocking, as the reference: in graph mode the layers hold what
            # the graph writes, and the next chunk overwrites it
            store.save(end, layers, extra={"beta": b, "step": end}, blocking=True)
            print(f"[pareto] step {end:5d}  β={b:.2e}  "
                  f"loss={losses[-1]:.4f}  "
                  f"ebops={res.metrics['ebops'][-1]:.3g}", flush=True)
    return chunks, opt_state


def run(args) -> dict:
    """Execute the sweep; returns (and writes) the frontier payload."""
    return sweep(args)[0]


def sweep(args) -> Tuple[dict, dict]:
    """Execute the sweep: the payload, and what produced it: ``"chunks"``
    (one ``(step, k, dt_s, host_s, compiled)`` a chunk), ``"compiled"``
    (snapshot step -> ``(opt_prog, gate, prog, engine)``), ``"rtl"`` (the
    selected point's attestation or None) and ``"settings"``."""
    from repro_torch.ckpt.store import CheckpointStore
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.data.synthetic import jsc_hlf
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.train.steps import TrainHParams, make_lut_train_step

    cfg = resolve_settings(args)
    steps, batch, n_snap, dims = cfg.steps, cfg.batch, cfg.n_snap, list(cfg.dims)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ------------------------------------------------------------- data
    xtr, ytr = jsc_hlf(args.seed, cfg.n_train, "train")
    xval, yval = jsc_hlf(args.seed, cfg.n_eval, "val")
    xte, yte = jsc_hlf(args.seed, cfg.n_eval, "test")
    xtr, xval, xte = _quantize(xtr), _quantize(xval), _quantize(xte)
    val = (torch.as_tensor(xval, device=device), torch.as_tensor(yval, device=device))
    test = (torch.as_tensor(xte, device=device), torch.as_tensor(yte, device=device))

    # ------------------------------------------------------------ model
    layers = build_lut_stack(dims, args.hidden, device=device,
                             generator=torch.Generator().manual_seed(args.seed))
    beta = BetaSchedule(args.beta_init, args.beta_final, steps)
    hp = TrainHParams(
        adam=AdamConfig(lr=args.lr),
        beta=beta,
        lr_schedule=cosine_restarts(args.lr, first_period=max(steps // 3, 10),
                                    warmup=min(30, steps // 10 + 1)))
    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()

    # ------------------------------------------- train once, snapshotting
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="pareto_ckpt_")
    store = CheckpointStore(ckpt_dir, keep=n_snap + 1)
    if store.list_steps():
        # retention keeps the globally highest step numbers, so a directory
        # holding an earlier (longer) run would evict THIS run's snapshots,
        # or restore stale params under fresh β labels
        raise SystemExit(
            f"--ckpt-dir {ckpt_dir} already contains checkpoints "
            f"(steps {store.list_steps()}); use an empty directory per "
            f"sweep so snapshot retention and restore stay unambiguous")
    snap_steps = _snapshot_steps(steps, n_snap)
    print(f"[pareto] one β-ramped run: {steps} steps, "
          f"β {args.beta_init:.1e} -> {args.beta_final:.1e}, "
          f"snapshots at {snap_steps} (chunks of {args.chunk_steps}, "
          f"prefetch {'off' if args.no_prefetch else 'on'}) on {device} -> {ckpt_dir}")
    # stateful host RNG drawn once per step: the prefetch thread calls
    # get_batch strictly in step order (data/pipeline.py contract)
    rng = np.random.default_rng(args.seed)

    def get_batch(_step: int) -> dict:
        idx = rng.integers(0, len(xtr), batch)
        return {"x": xtr[idx], "y": ytr[idx]}

    t0 = time.time()
    chunks, _ = train_snapshots(step_fn, layers, opt, get_batch, steps, snap_steps,
                             store=store, beta=beta, chunk_steps=args.chunk_steps,
                             prefetch=not args.no_prefetch)
    t_train = time.time() - t0

    # ------------------------------- compile + measure every snapshot
    points = []
    # snap -> (opt_prog, gate, prog, engine) for _serve_selected; the
    # UNoptimized prog and the snapshot's engine ride along so the selected
    # point's --verify-rtl attestation can be three-way without re-lowering
    compiled = {}
    for snap in snap_steps:
        # a copy of the stack, in eval mode: the training layers (and their
        # BN moving stats) are never touched after training
        snap_layers = copy.deepcopy(layers)
        _, _opt, manifest = store.restore(snap_layers, step=snap)
        for layer in snap_layers:
            layer.eval()
        point, compiled[snap] = measure_point(
            snap_layers, step=snap, beta=manifest["beta"], val=val, test=test,
            engine=args.engine, n_gate=cfg.n_gate, bench_batch=cfg.bench_batch,
            bench_rounds=cfg.bench_rounds, seed=args.seed)
        points.append(point)
        live_pct = (100.0 * point["live_entries"] / point["table_entries"]
                    if "live_entries" in point else float("nan"))
        print(f"[pareto] snap {snap:5d}  β={manifest['beta']:.2e}  "
              f"val={point['val_acc']:.4f} test={point['test_acc']:.4f}  "
              f"EBOPs={point['ebops']:9.1f} est.LUTs={point['est_luts']:8.0f}  "
              f"LLUTs {point['n_llut']}->{point['n_llut_live']}  "
              f"gather {point['gather_width']}->{point['gather_width_dce']}  "
              f"width req={point['required_width']} "
              f"proven={point['proven_width']}  "
              f"live={live_pct:.0f}%  "
              f"{point['engine_us']:.0f} us/batch ({point['engine_path']})", flush=True)

    # ----------------------------------------------- frontier + selection
    frontier, top, selected = select_frontier(points, args.select_tol)
    print(f"[pareto] frontier: {len(frontier)}/{len(points)} points; "
          f"selected step {selected['step']} "
          f"(val {selected['val_acc']:.4f} vs best {top['val_acc']:.4f}, "
          f"est.LUTs {selected['est_luts']:.0f} vs {top['est_luts']:.0f})")

    # ------------------------------- serve the selected operating point
    serve_stats, rtl = None, None
    if cfg.n_requests > 0:
        opt_prog, gate, orig_prog, engine = compiled[selected["step"]]
        if args.verify_rtl:
            # hardware-level gate on the point we actually ship: the DCE'd
            # program's Verilog, simulated, vs the UNoptimized interpreter
            # vs the snapshot's engine; rides into the bundle attestation
            from repro_torch.core.rtl import verify_rtl
            t0 = time.time()
            rtl = verify_rtl(opt_prog, oracle=orig_prog, engine=engine,
                             n_random=cfg.n_gate, seed=args.seed)
            gate = {**gate, "rtl": rtl}
            print(f"[pareto] rtl gate PASSED for step {selected['step']}: "
                  f"{rtl['verdict']} over {rtl['random']} random + "
                  f"{rtl['exhaustive']} exhaustive rows (verilog sha256 "
                  f"{rtl['verilog_sha256'][:12]}, {time.time() - t0:.2f}s)")
        serve_stats = _serve_selected(args, cfg, device, store.dir, selected,
                                      opt_prog, gate)

    # a default (temp) snapshot dir is working space, not a product: drop
    # it.  An explicit --ckpt-dir keeps snapshots AND the served bundle.
    keep_ckpts = args.ckpt_dir is not None
    if serve_stats is not None:
        serve_stats["bundle_kept"] = keep_ckpts
    if not keep_ckpts:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        print(f"[pareto] temp snapshot dir removed ({ckpt_dir}); pass "
              f"--ckpt-dir to keep snapshots + the served bundle")

    payload = _plain({
        "task": "jsc_hlf",
        "dims": dims, "hidden": args.hidden,
        "steps": steps, "batch": batch, "train_wall_s": t_train,
        "beta_init": args.beta_init, "beta_final": args.beta_final,
        "selected_step": selected["step"],
        "select_tol": args.select_tol,
        "serve": serve_stats,
        "points": points,
        "note": ("single β-ramped training run; every point is one ckpt/store "
                 "snapshot pushed through extract_tables -> lower -> "
                 "core/opt DCE -> serving engine, gated bit-exact against the "
                 "unoptimized DaisProgram.run; est_luts is the paper's "
                 "exp(0.985·log EBOPs) calibration"),
    })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"[pareto] wrote {args.out} ({len(points)} operating points)")
    return payload, {"chunks": chunks, "compiled": compiled, "rtl": rtl,
                     "settings": cfg}


def _serve_selected(args, cfg: Settings, device, bundle_dir, selected, opt_prog,
                    gate) -> dict:
    """Bundle the chosen snapshot and serve it through the tier.

    ``opt_prog``/``gate`` are the DCE'd program and its verify statistics
    the per-snapshot loop already produced — nothing is re-lowered or
    re-gated here.  The bundle is registered into a 2-replica
    :class:`~repro_torch.serve.tier.ServeTier` (``serve/api.py``); the
    interpreter comparison runs the same open-loop submission against
    ``InterpreterBackend`` behind a ``MicroBatcher``, so the reported ratio
    is service path against service path.
    """
    from repro_torch.kernels.lut_serve import input_code_bounds
    from repro_torch.serve.api import EngineSpec, build, tier_from_built
    from repro_torch.serve.artifact import save_artifact
    from repro_torch.serve.scheduler import (InterpreterBackend, MicroBatcher,
                                             ServeConfig, drive_open_loop)
    from repro_torch.serve.tier import TierConfig

    n_requests = cfg.n_requests
    bundle = os.path.join(bundle_dir, f"pareto_step{selected['step']}.npz")
    # the attestation records WHICH operating point this bundle is: the
    # snapshot's β and EBOPs ride with the gate statistics under the
    # bundle's content hash
    digest = save_artifact(bundle, opt_prog, attestation={
        **gate, "beta": selected["beta"], "ebops": selected["ebops"],
        "est_luts": selected["est_luts"], "step": selected["step"],
        "dce_llut": selected["n_llut_live"]})
    # verify="cached": the bundle's stored attestation is the per-snapshot
    # gate that just ran, tied to these bytes by the content hash
    built = build(bundle, EngineSpec(
        engine=None if args.engine == "fused" else args.engine,
        verify="cached"), device=device)
    print(f"[pareto] operating point bundled: {bundle} (hash {digest[:12]}, "
          f"attested β={built.attestation['beta']:.2e} "
          f"EBOPs={built.attestation['ebops']:.1f})")

    lo, hi = input_code_bounds(opt_prog)
    rng = np.random.default_rng(args.seed)
    codes = rng.integers(lo, hi + 1, (n_requests, len(lo)), np.int64)
    ref = np.asarray(opt_prog.run(codes), np.int64)
    name = f"pareto_step{selected['step']}"
    scfg = ServeConfig(max_batch=cfg.max_batch, max_delay_ms=2.0)
    tier = tier_from_built({name: built},
                           TierConfig(n_replicas=2, serve=scfg),
                           start=False)
    with tier:
        out, drive = drive_open_loop(
            None, codes, rate=0.0,
            submit=lambda row: tier.submit(row, name))
    if not np.array_equal(out.astype(np.int64), ref):
        raise AssertionError("tier responses diverged from DaisProgram.run "
                             "— refusing to report serve numbers")
    s = tier.stats()
    with MicroBatcher(InterpreterBackend(opt_prog), scfg) as mb:
        _, idrive = drive_open_loop(mb, codes, rate=0.0)
    rows_per_s = n_requests / drive["wall_s"]
    interp_rows_per_s = n_requests / idrive["wall_s"]
    print(f"[pareto] served {n_requests} requests through the tier "
          f"({tier.config.n_replicas} replicas, model {name!r}): "
          f"p50={s.p50_ms:.2f} ms p99={s.p99_ms:.2f} ms "
          f"{rows_per_s:,.0f} rows/s "
          f"({rows_per_s / interp_rows_per_s:.1f}x the "
          f"interpreter behind the single-engine scheduler)")
    return {"bundle": bundle, "content_hash": digest,
            "n_requests": n_requests,
            "engine": {"p50_ms": s.p50_ms, "p99_ms": s.p99_ms,
                       "rows_per_s": rows_per_s},
            "tier": {"n_replicas": tier.config.n_replicas,
                     "n_batches": s.n_batches, "n_stolen": s.n_stolen},
            "interp_rows_per_s": interp_rows_per_s}


def main(argv=None) -> None:
    run(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()
