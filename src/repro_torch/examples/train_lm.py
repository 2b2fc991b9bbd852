"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
(port of ``examples/train_lm.py``).

Config → model zoo → train step → β-scheduled HGQ quantization (kernel B1
on the card) → chunked driver with async checkpoints → restart-resume.  The
constants are the reference's: LM100M (106 M parameters, HGQ, qk-norm),
AdamW 6e-4 with weight decay 0.01, β 1e-12 → 1e-10, cosine restarts with a
20-step warm-up, chunks of 10 steps, a checkpoint every 100 steps.  A
checkpoint directory that holds one resumes from it, as the reference's.
``--smoke`` swaps LM100M for a small config of the same family (CPU tests).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
"""

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.ckpt.store import CheckpointStore
from repro_torch.configs.base import ArchConfig
from repro_torch.core.ebops import BetaSchedule
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.registry import build_model
from repro_torch.nn.params import count_params
from repro_torch.optim.adam import AdamConfig, cosine_restarts
from repro_torch.train.loop import chunked_train
from repro_torch.train.steps import TrainHParams, init_state, make_train_step

# ~106M parameters: glu(3*640*2560)*10 + attn(4*640^2)*10 + embed 2*32k*640
LM100M = ArchConfig(
    name="lm100m", family="lm",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=2560, vocab=32000,
    qk_norm=True, mlp_type="glu", act="silu",
    quant="hgq",            # the paper's technique as a first-class feature
    q_chunk=64,
)
SMOKE = dataclasses.replace(LM100M, name="lm100m_smoke", n_layers=2, d_model=64,
                            n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, q_chunk=16)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "lm100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="a 2-layer, 64-wide config of the same family")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SMOKE if args.smoke else LM100M

    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(0))
    print(f"[train_lm] {count_params(model.defs())/1e6:.1f}M parameters")

    hp = TrainHParams(
        adam=AdamConfig(lr=6e-4, weight_decay=0.01),
        beta=BetaSchedule(1e-12, 1e-10, args.steps),  # gentle EBOPs pressure
        lr_schedule=cosine_restarts(6e-4, first_period=args.steps, warmup=20),
    )
    raw_step, _ = make_train_step(model, hp=hp)
    params, opt = init_state(model)
    store = CheckpointStore(args.ckpt_dir, keep=2)
    start = 0
    if store.latest_step() is not None:
        model, opt, man = store.restore(model, opt)
        start = man["step"]
        print(f"[train_lm] resumed from step {start}")

    def get_batch(step: int) -> dict:
        return dict(lm_batch(0, step, args.batch, args.seq, cfg.vocab))

    losses = []
    t0 = time.time()
    # chunked driver (train/loop.py): 10 steps a chunk, batches prefetched on
    # a background thread; chunks end on the checkpoint cadence
    for res in chunked_train(raw_step, params, opt, get_batch,
                             start, args.steps, chunk_steps=10,
                             boundaries=range(100, args.steps, 100)):
        opt = res.opt_state
        losses.extend(float(v) for v in res.metrics["ce"])
        for i in range(res.k):
            step = res.step + i
            if step % 20 == 0:
                dt = (time.time() - t0) / (step - start + 1)
                print(f"step {step:4d}  ce={float(res.metrics['ce'][i]):.4f}  "
                      f"ebops={float(res.metrics['ebops'][i]):.3g}  "
                      f"{dt:.2f}s/step", flush=True)
        end = res.step + res.k
        if end % 100 == 0:
            store.save(end, model, opt)
    store.wait()
    wall = time.time() - t0
    first = sum(losses[:10]) / 10
    last = sum(losses[-10:]) / 10
    print(f"[train_lm] ce {first:.3f} -> {last:.3f} over steps {start}..{args.steps} "
          f"({wall/60:.1f} min)")
    if start == 0 and not last < first:
        raise SystemExit("loss did not improve")
    return {"first": first, "last": last, "start": start, "steps": args.steps,
            "wall_s": wall, "n_params": count_params(model.defs())}


if __name__ == "__main__":
    main()
