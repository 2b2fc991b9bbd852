"""Accuracy–resource Pareto frontier from a SINGLE training run (paper §V-A),
port of ``examples/pareto_sweep.py``.

The β trade-off parameter ramps exponentially during training; snapshots
taken along the ramp trace the accuracy-vs-EBOPs frontier, with no
per-point retraining: HGQ(-LUT)'s "automatic exploration of
accuracy-resource trade-offs without manual bit-width tuning".

This example stops at the *training-side* frontier (accuracy vs EBOPs),
with the reference's constants: the JSC-HLF stack 16 -> 20 (BN) -> 5,
hidden 8, 1500 steps at B = 1024, β 5e-7 -> 1.5e-4, Adam 3e-3 with cosine
restarts, a snapshot every 150 steps, and the best validation point per
0.1 of log10(LUTs).  Every step runs the einsum path (kernel B1 on the
card).  The full pipeline (snapshots checkpointed, compiled through DCE and
the bit-exact gate, a selected point served) is
``python -m repro_torch.launch.pareto``.

Run::

    PYTHONPATH=src python -m repro_torch.examples.pareto_sweep [--device cuda|cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

STEPS = 1500
BATCH = 1024
SNAP_EVERY = 150


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale run: 30 steps of 256 on 2000 rows, "
                         "a snapshot every 3")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.ebops import BetaSchedule, estimate_luts
    from repro_torch.data.synthetic import jsc_hlf
    from repro_torch.launch.pareto import _quantize, evaluate
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.train.steps import TrainHParams, make_lut_train_step

    steps, snap_every = (30, 3) if args.smoke else (STEPS, SNAP_EVERY)
    batch = 256 if args.smoke else BATCH
    n_train, n_eval = (2000, 500) if args.smoke else (20000, 5000)

    xtr, ytr = jsc_hlf(0, n_train, "train")
    xval, yval = jsc_hlf(0, n_eval, "val")
    xte, yte = jsc_hlf(0, n_eval, "test")
    xtr, xval, xte = _quantize(xtr), _quantize(xval), _quantize(xte)
    xtr_d, ytr_d = torch.as_tensor(xtr, device=device), torch.as_tensor(ytr, device=device)
    val = (torch.as_tensor(xval, device=device), torch.as_tensor(yval, device=device))
    test = (torch.as_tensor(xte, device=device), torch.as_tensor(yte, device=device))

    layers = build_lut_stack([16, 20, 5], 8, device=device,
                             generator=torch.Generator().manual_seed(0))
    # paper's HLF JSC range is 5e-7 → 1e-3; on the synthetic analogue the
    # frontier's informative span ends nearer 1e-4 (β=1e-3 prunes to chance)
    beta = BetaSchedule(5e-7, 1.5e-4, steps)
    hp = TrainHParams(adam=AdamConfig(lr=3e-3), beta=beta,
                      lr_schedule=cosine_restarts(3e-3, first_period=steps // 3,
                                                  warmup=min(30, steps)))
    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()

    rng = np.random.default_rng(0)
    frontier = []
    t0 = time.time()
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(xtr), batch), device=device)
        opt, metrics = step_fn(opt, {"x": xtr_d[idx], "y": ytr_d[idx]})
        if (s + 1) % snap_every == 0:
            for layer in layers:
                layer.eval()
            val_acc, test_acc = evaluate(layers, *val), evaluate(layers, *test)
            eb = float(metrics["ebops"])
            b = float(beta(torch.tensor(s, dtype=torch.int32, device=device)))
            frontier.append((s + 1, b, eb, estimate_luts(eb), val_acc, test_acc))
            print(f"step {s+1:5d}  beta={b:.2e}  "
                  f"EBOPs={eb:9.1f}  est.LUTs={frontier[-1][3]:8.0f}  "
                  f"val={val_acc:.4f}  test={test_acc:.4f}", flush=True)
    wall = time.time() - t0

    print(f"\nsweep: {wall:.0f}s.  Pareto points (selected on val):")
    best = {}
    for s, b, eb, luts, va, ta in frontier:
        key = round(np.log10(max(luts, 1)), 1)
        if key not in best or va > best[key][4]:
            best[key] = (s, b, eb, luts, va, ta)
    print(f"{'LUTs':>9s} {'EBOPs':>9s} {'val':>7s} {'test':>7s}")
    for key in sorted(best):
        s, b, eb, luts, va, ta = best[key]
        print(f"{luts:9.0f} {eb:9.0f} {va:7.4f} {ta:7.4f}")
    return {"steps": steps, "batch": batch, "wall_s": wall, "snapshots": frontier,
            "pareto": [best[k] for k in sorted(best)]}


if __name__ == "__main__":
    main()
