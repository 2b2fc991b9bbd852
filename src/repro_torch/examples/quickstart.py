"""Quickstart of the port: the paper's Fig. 1 flow on one device, RTL excepted.

1. build the JSC-HLF LUT-Dense classifier (16 -> 20 with batch-norm -> 5,
   hidden 8) from a seeded generator;
2. train it with the β·EBOPs objective through ``make_lut_train_step`` on
   the fused path (kernels B1, B2 and B3 on the card);
3. evaluate it on the test split;
4. lower it to a DAIS program; the eval forward must equal
   ``DaisProgram.run_float`` exactly;
5. build the serving engine (``engine="pallas"``, kernel B4 on the card)
   behind the bit-exact gate and serve the test set's input codes, each
   batch checked against ``DaisProgram.run``.

Run (on the card, or on the CPU with the kernels' plain versions)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu] [--smoke] [--steps N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

BATCH = 1024
DIMS = (16, 20, 5)
HIDDEN = 8
IN_F, IN_I = 4, 3  # input fixed-point format (paper: no clamping needed)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale run: few steps, small data, the same "
                         "train -> lower -> gate -> serve pipeline")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the training step count")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.ebops import BetaSchedule, estimate_luts
    from repro_torch.core.lower import compile_sequential
    from repro_torch.core.quant import int_to_float, quantize_to_int
    from repro_torch.data.synthetic import jsc_hlf
    from repro_torch.launch.serve import build_lut_stack
    from repro_torch.optim.adam import AdamConfig, cosine_restarts
    from repro_torch.serve.api import EngineSpec, build
    from repro_torch.train.steps import TrainHParams, make_lut_train_step

    steps = args.steps if args.steps is not None else (30 if args.smoke else 600)
    n_train, n_test = (2000, 500) if args.smoke else (20000, 5000)
    batch = 256 if args.smoke else BATCH

    # ---------------------------------------------------------------- data
    xtr, ytr = jsc_hlf(seed=0, n=n_train, split="train")
    xte, yte = jsc_hlf(seed=0, n=n_test, split="test")
    # inputs arrive pre-quantized, as they would from the detector front-end
    ctr = quantize_to_int(xtr, IN_F, IN_I, True, "SAT")
    cte = quantize_to_int(xte, IN_F, IN_I, True, "SAT")
    xtr = int_to_float(ctr, IN_F).astype(np.float32)
    xte = int_to_float(cte, IN_F).astype(np.float32)

    # --------------------------------------------------------------- train
    gen = torch.Generator().manual_seed(args.seed)
    layers = build_lut_stack(list(DIMS), HIDDEN, device=device, generator=gen)
    hp = TrainHParams(adam=AdamConfig(lr=3e-3),
                      beta=BetaSchedule(5e-7, 1e-4, steps),   # paper §V-A HLF JSC
                      lr_schedule=cosine_restarts(3e-3, first_period=max(steps // 2, 1),
                                                  warmup=min(30, steps // 2)),
                      lut_use_fused=True)
    step_fn, init_fn = make_lut_train_step(layers, hp)
    opt = init_fn()
    xtr_d = torch.as_tensor(xtr, device=device)
    ytr_d = torch.as_tensor(ytr, device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    metrics = {}
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, len(xtr), batch), device=device)
        opt, metrics = step_fn(opt, {"x": xtr_d[idx], "y": ytr_d[idx]})
        if s % 100 == 0 or s == steps - 1:
            print(f"step {s:4d}  ce={float(metrics['ce']):.4f}  "
                  f"ebops={float(metrics['ebops']):9.1f}")
    print(f"training: {time.monotonic() - t0:.1f}s for {steps} steps of "
          f"{batch} on {device}")

    # ------------------------------------------------------------ evaluate
    for layer in layers:
        layer.eval()
    with torch.no_grad():
        logits = torch.as_tensor(xte, device=device)
        for layer in layers:
            logits, _ = layer(logits)
    logits = logits.cpu().numpy().astype(np.float64)
    acc = float(np.mean(np.argmax(logits, -1) == yte))
    eb = float(metrics["ebops"]) if metrics else 0.0
    print(f"test accuracy: {acc:.4f}   EBOPs: {eb:.0f}   "
          f"estimated FPGA LUTs: {estimate_luts(eb):.0f}")

    # ----------------------------------------------- lower to DAIS, verify
    t0 = time.monotonic()
    prog = compile_sequential(layers, IN_F, IN_I)
    print(f"DAIS lowering: {time.monotonic() - t0:.2f}s, {prog.n_instrs()} "
          f"instrs {prog.count_ops()}")
    n_chk = min(2048, n_test)
    exact = float(np.abs(prog.run_float(xte[:n_chk]) - logits[:n_chk]).max())
    print(f"bit-exact check (DAIS vs eval forward): max|d| = {exact} "
          f"{'BIT-EXACT' if exact == 0 else 'MISMATCH'}")
    if exact != 0.0:
        raise SystemExit("the eval forward diverged from DaisProgram.run_float")

    # ------------------------------------------------ serve behind the gate
    built = build(prog, EngineSpec(engine="pallas", require="pallas",
                                   verify="full", n_random=512 if args.smoke else 2048,
                                   seed=args.seed), device=device)
    engine = built.engine
    print(f"serving engine: path={engine.path}, gate PASSED over "
          f"{built.attestation['random']} random + "
          f"{built.attestation['exhaustive']} exhaustive rows")
    served = 0
    for lo in range(0, n_test, batch):
        codes = cte[lo:lo + batch]
        out = engine.run(codes)
        if not np.array_equal(out.cpu().numpy().astype(np.int64), prog.run(codes)):
            raise SystemExit("served batch diverged from DaisProgram.run")
        served += len(codes)
    print(f"served {served} test rows bit-exactly in {-(-n_test // batch)} batches")
    return {"acc": acc, "ebops": eb, "exact": exact, "served": served,
            "path": engine.path, "steps": steps}


if __name__ == "__main__":
    main()
