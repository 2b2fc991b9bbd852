"""Training launcher of the port, with checkpoint/restart fault tolerance
(port of ``repro.launch.train``; LM configs only, ``--arch``).

The hot loop is the chunked driver (``train/loop.py::chunked_train``):
``--chunk-steps`` K optimizer steps per chunk, run as one CUDA graph per
distinct k on the card and as a plain loop on the CPU (``--mode`` picks one
explicitly: ``--mode eager`` is the plain loop on the card too, for steps
of so many kernels that a capture costs more than its replays save, as
OLMo-1B's ~48k a step); metrics cross to the host
once per chunk, and batch synthesis and the copy to the card for the next
chunk run on a background prefetch thread (``--no-prefetch`` for the
synchronous fallback).  Chunk boundaries land exactly on the checkpoint
cadence and the simulated-crash step, so fault-tolerance semantics are the
per-step loop's, and grouping steps changes no bit of the result.

Fault tolerance, as in the reference:

* every ``--ckpt-every`` steps an async atomic checkpoint is written
  (parameters, Adam state, the manifest), in the reference's flat keys, so
  either package resumes the other's; a restart resumes bit-exactly from
  the last one, and ``--simulate-crash N`` ends the process with exit code
  17 after step N to prove it;
* the data is a pure function of (seed, step): a restarted process needs no
  coordination to rejoin;
* a step-time watchdog (EMA) flags stragglers; chunks that include a
  capture never seed or trip it.

The parameters are drawn from ``--seed`` on ``--device`` (default ``cuda``;
the launcher exits when no card is visible).  Float32 matmuls run without
TF32, as everywhere in the port.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --steps 100 \\
        --batch 8 --seq 128 --ckpt-dir /tmp/run1
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    # β trade-off schedule; None defaults so that an explicit 0.0 is kept
    ap.add_argument("--beta-init", type=float, default=None,
                    help="β at step 0 (default: 0 constant, or 5e-7 — the "
                         "paper's ramp start — when --beta-final is set)")
    ap.add_argument("--beta-final", type=float, default=None,
                    help="β at the last step for the exponential ramp "
                         "(omit for constant β at --beta-init)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--chunk-steps", type=int, default=8,
                    help="optimizer steps per chunk; chunks never cross "
                         "--ckpt-every/--simulate-crash boundaries "
                         "(1 = per-step dispatch)")
    ap.add_argument("--mode", choices=("graph", "eager"), default=None,
                    help="how a chunk runs: one CUDA graph per distinct length "
                         "(graph) or a plain loop of steps (eager); default "
                         "graph on a card, eager on the CPU")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="build batch chunks synchronously on the critical "
                         "path instead of on the background prefetch thread")
    ap.add_argument("--simulate-crash", type=int, default=0,
                    help="exit(17) after this step (fault-tolerance tests)")
    ap.add_argument("--straggler-factor", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    return ap


def resolve_beta(args):
    """``(beta_init, beta_final)`` from the flags; exits on an invalid ramp."""
    from repro_torch.core.ebops import beta_ramp_error

    if args.beta_final is None:
        beta_init = args.beta_init if args.beta_init is not None else 0.0
    else:
        # ramp requested: default the start to the paper's 5e-7 (§V-A)
        beta_init = args.beta_init if args.beta_init is not None else 5e-7
    err = beta_ramp_error(beta_init, args.beta_final)
    if err:
        raise SystemExit(f"--beta-init/--beta-final: {err}")
    return beta_init, args.beta_final


def make_get_batch(model, args):
    """``get_batch(step)``: ``lm_batch`` plus deterministic pseudo-embeddings
    for modality stubs (a VLM's ``patch_embeds``, Whisper's ``frames``:
    ``input_specs``' shapes, bf16 values as float32), a pure function of
    (seed, step)."""
    from repro_torch.data.synthetic import lm_batch

    stubs = {k: v.shape for k, v in model.input_specs(args.seq, args.batch, "train").items()
             if k not in ("tokens", "labels")}
    vocab = model.cfg.vocab

    def get_batch(step: int) -> dict:
        out = dict(lm_batch(args.seed, step, args.batch, args.seq, vocab))
        for k, shape in stubs.items():
            rng = np.random.default_rng([args.seed, step, 7])
            a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
            out[k] = a.to(torch.bfloat16).float().numpy()
        return out

    return get_batch


def main(argv=None) -> dict:
    """Run the launcher; returns ``{"steps", "start", "metrics" (name ->
    per-step array of the steps run), "chunks" ((step, k, dt_s, host_s,
    compiled) each), "train_s", "model", "opt"}``."""
    args = build_argparser().parse_args(argv)

    from repro_torch.ckpt.store import CheckpointStore
    from repro_torch.configs.base import get_config, get_smoke
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.train.loop import chunked_train
    from repro_torch.train.steps import TrainHParams, init_state, make_train_step

    beta_init, beta_final = resolve_beta(args)
    if args.chunk_steps < 1:
        raise SystemExit(f"--chunk-steps {args.chunk_steps}: must be >= 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    if args.mode == "graph" and device.type != "cuda":
        raise SystemExit(f"--mode graph captures CUDA graphs and needs --device cuda, "
                         f"got {device}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)
    hp = TrainHParams(
        adam=AdamConfig(lr=args.lr),
        beta=BetaSchedule(beta_init, beta_final, args.steps),
        lr_schedule=cosine_restarts(args.lr, first_period=max(args.steps // 2, 10),
                                    warmup=min(20, args.steps // 10 + 1)),
    )
    raw_step, _ = make_train_step(model, hp=hp)
    params, opt = init_state(model)
    start_step = 0
    store = CheckpointStore(args.ckpt_dir) if args.ckpt_dir else None
    if store and store.latest_step() is not None:
        model, opt, manifest = store.restore(model, opt)
        start_step = manifest["step"]
        print(f"[train] resumed from step {start_step}")

    get_batch = make_get_batch(model, args)
    # chunks must END on every step with host-visible side effects
    boundaries = set(range(args.ckpt_every, args.steps, args.ckpt_every))
    if args.simulate_crash:
        boundaries.add(max(args.simulate_crash, start_step + 1))

    def save(step: int, blocking: bool = False) -> None:
        store.save(step, model, opt, extra={"seed": args.seed, "arch": args.arch},
                   blocking=blocking)

    ema = None
    rows, chunks = [], []
    t0 = time.perf_counter()
    for res in chunked_train(raw_step, params, opt, get_batch, start_step, args.steps,
                             chunk_steps=args.chunk_steps, boundaries=boundaries,
                             prefetch=not args.no_prefetch, mode=args.mode):
        opt, metrics = res.opt_state, res.metrics
        rows.append(metrics)
        chunks.append((res.step, res.k, res.dt_s, res.host_s, res.compiled))
        for i in range(res.k):
            step = res.step + i
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} "
                      f"loss={metrics['loss'][i]:.4f} "
                      f"ce={metrics['ce'][i]:.4f} "
                      f"ebops={metrics['ebops'][i]:.3g} "
                      f"gnorm={metrics['grad_norm'][i]:.3f} "
                      f"lr={metrics['lr'][i]:.2e}", flush=True)
        # watchdog: dt_s runs dispatch -> host-visible metrics; chunks that
        # captured a graph never seed the straggler EMA
        if not res.compiled:
            dt_step = res.dt_s / res.k
            if ema is not None and dt_step > args.straggler_factor * ema:
                print(f"[watchdog] steps {res.step}..{res.step + res.k - 1} "
                      f"took {dt_step:.3f}s/step (EMA {ema:.3f}s) — "
                      f"straggler signal", flush=True)
            ema = dt_step if ema is None else 0.9 * ema + 0.1 * dt_step
        end = res.step + res.k
        if store and end % args.ckpt_every == 0:
            save(end)
        if args.simulate_crash and end >= args.simulate_crash:
            if store:
                save(end, blocking=True)
            print(f"[train] simulating crash at step {end}", flush=True)
            os._exit(17)
    train_s = time.perf_counter() - t0

    if store:
        save(args.steps, blocking=True)
    merged = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]} if rows else {}
    if merged:
        print(f"[train] done: {args.steps} steps, final loss {float(merged['loss'][-1]):.4f}")
    return {"steps": args.steps, "start": start_step, "metrics": merged,
            "chunks": chunks, "train_s": train_s, "model": model, "opt": opt}


if __name__ == "__main__":
    main()
