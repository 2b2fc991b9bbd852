"""CEPC gas-detector PID by cluster counting (paper §V-F), port of
``examples/pid_hybrid.py``.

The hybrid is the paper's (``models/pid.py``): one conventional (matmul) HGQ
conv layer projects each 20-sample ADC window to 8 features, then two
LUT-Conv layers, a time-independent LUT head and window-count accumulation.
It trains with a fixed β = 1e-7 (one target design point, < 10k LUTs) on
MSE + β·EBOPs against the per-window cluster counts.  The observable is the
kaon/pion separation power S = (μ_K − μ_π) / ((σ_K + σ_π)/2) of the
predicted counts.

Steps:

1. waveforms from ``data/synthetic.cepc_waveform`` at its own 3000-sample
   length (``--smoke``: 200), quantized onto the 12-bit ADC grid;
2. ``--steps`` train steps (``make_pid_train_step``: ``autograd.grad`` and
   ``optim/adam.adam_update`` with ``cosine_restarts``; kernel B1 on the
   card for every quantizer);
3. test separation power beside the truth-count reference;
4. ``lower`` of the hybrid graph over a ``--ctx``-sample context, then
   ``build(EngineSpec(engine="pallas", require="fused"))`` behind the
   bit-exact gate (kernel B4 on the card);
5. the eval forward against ``DaisProgram.run_float`` (``bias_gap``): equal
   bit for bit with the front's bias on the program's grid; with the float
   bias only the windows next to an lc1 input tie may move, and the gap is
   reported (the reference asserts it below 0.5, which is no bound,
   ROADMAP C12); then the test waveforms' codes served bit for bit against
   ``DaisProgram.run``, as one batch and as single requests through the
   micro-batching scheduler (``MicroBatcher``, ``max_batch=16``);
6. the program's Verilog written to ``--verilog`` (default:
   ``pid_hybrid.v`` in the temporary directory) and the three-way
   attestation: RTL simulation == DAIS interpreter == the engine on its
   device (``verify_rtl``).

Run (on the card, or on the CPU with the kernels' plain versions)::

    PYTHONPATH=src python -m repro_torch.examples.pid_hybrid [--device cuda|cpu] [--smoke] [--steps N] [--ctx N] [--verilog PATH]
"""

from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

BETA = 1e-7          # paper: fixed beta, budget < 10k LUTs
LR = 2e-3
WF_LEN = 3000        # cepc_waveform's own length: 150 windows
BATCH = 128


def forward(layers, wf: torch.Tensor, *, fused=None):
    """(B, T) waveforms -> per-window counts (B, T/20) and the merged Aux.
    ``fused`` routes the LUT layers through kernels B2/B3 for this call."""
    from repro_torch.nn.base import merge_aux

    front, lc1, lc2, head = layers
    h, a0 = front(wf[..., None], fused=fused)          # (B, T/20, 8)
    h, a1 = lc1(h, fused=fused)
    h, a2 = lc2(h, fused=fused)
    counts, a3 = head(h, fused=fused)                  # (B, T/20, 1)
    return counts[..., 0], merge_aux(a0, a1, a2, a3)


def separation(pred_counts, species) -> float:
    tot = np.asarray(pred_counts, np.float64)
    if tot.ndim > 1:
        tot = tot.sum(axis=1)
    k, p = tot[species == 1], tot[species == 0]
    return float((k.mean() - p.mean()) / ((k.std() + p.std()) / 2 + 1e-9))


def pid_loss_and_grads(layers, wf, cnt, *, beta: float = BETA, fused=None):
    """Train-mode forward and the gradients of MSE + β·EBOPs.  Returns
    ``(loss, mse, ebops, grads)``, ``grads`` keyed like
    ``models.pid.pid_named_params``."""
    from repro_torch.models.pid import pid_named_params

    params = pid_named_params(layers)
    for layer in layers:
        layer.train(True)
    pred, aux = forward(layers, wf, fused=fused)
    mse = torch.mean(torch.square(pred - cnt))
    total = mse + beta * aux.ebops
    got = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), got)}
    return total.detach(), mse.detach(), aux.ebops.detach(), grads


def make_pid_train_step(layers, steps: int, *, lr: float = LR,
                        beta: float = BETA, fused=None):
    """The reference example's step: MSE + β·EBOPs, Adam (``lr``) with
    cosine restarts over ``steps`` and a warm-up of ``min(20, steps // 2)``.

    Returns ``(step_fn, init_fn)``; ``step_fn(opt, wf, cnt)`` updates the
    layers in place and returns ``(opt, metrics)``, metrics as tensors.
    """
    from repro_torch.models.pid import pid_named_params
    from repro_torch.optim.adam import (AdamConfig, adam_init, adam_update,
                                        cosine_restarts)

    acfg = AdamConfig(lr=lr)
    sched = cosine_restarts(lr, first_period=steps, warmup=min(20, steps // 2))

    def step_fn(opt, wf, cnt):
        loss, mse, ebops, grads = pid_loss_and_grads(layers, wf, cnt, beta=beta,
                                                     fused=fused)
        params = pid_named_params(layers)
        new_p, opt, om = adam_update({k: p.detach() for k, p in params.items()},
                                     grads, opt, acfg, sched)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new_p[k])
        return opt, {"loss": loss, "mse": mse, "ebops": ebops, **om}

    def init_fn():
        return adam_init({k: p.detach() for k, p in pid_named_params(layers).items()})

    return step_fn, init_fn


def adc_data(seed: int, n: int, length: int, split: str):
    """``cepc_waveform`` quantized onto the 12-bit unsigned ADC grid, as the
    detector delivers it: (waveforms, window counts, species)."""
    from repro_torch.core.quant import int_to_float, quantize_to_int
    from repro_torch.data.synthetic import cepc_waveform
    from repro_torch.models.pid import IN_F, IN_I

    wf, cnt, sp = cepc_waveform(seed, n, length, split)
    wf = int_to_float(quantize_to_int(wf, IN_F, IN_I, False, "SAT"), IN_F)
    return wf.astype(np.float32), cnt, sp


def eval_counts(layers, wf: np.ndarray, device, chunk: int = 128) -> np.ndarray:
    """Eval-mode per-window counts of ``wf`` (float64, on the host)."""
    for layer in layers:
        layer.eval()
    out = []
    with torch.no_grad():
        for lo in range(0, len(wf), chunk):
            pred, _ = forward(layers, torch.as_tensor(wf[lo:lo + chunk], device=device))
            out.append(pred.cpu().numpy().astype(np.float64))
    return np.concatenate(out)


def _grid_front(front):
    """A copy of the front with its bias on the grid the lowering rounds it
    to (``core.lower.hgq_bias_on_grid``)."""
    from repro_torch.core.lower import hgq_bias_on_grid

    front = copy.deepcopy(front)
    with torch.no_grad():
        front.dense.b.copy_(torch.as_tensor(hgq_bias_on_grid(front.dense),
                                            dtype=torch.float32))
    return front


def deploy_counts(layers, wf: np.ndarray, device) -> np.ndarray:
    """``eval_counts`` with the front's bias on the program's grid: the
    function the lowered program computes, so its window sums equal
    ``DaisProgram.run_float`` bit for bit."""
    return eval_counts((_grid_front(layers[0]), *layers[1:]), wf, device)


def tie_sites(layers, wf: np.ndarray, device, chunk: int = 128) -> np.ndarray:
    """(B, T/20) bool: the lc1 sites whose quantized inputs differ between
    the front's float bias and its bias on the program's grid, i.e. where a
    front output lands on a rounding tie of lc1's input grid."""
    from repro_torch.core.lut_layers import im2col_1d
    from repro_torch.core.quant import fake_quant

    front, lc1 = layers[0], layers[1]
    fronts = (front, _grid_front(front))
    out = []
    with torch.no_grad():
        for lo in range(0, len(wf), chunk):
            x = torch.as_tensor(wf[lo:lo + chunk], device=device)[..., None]
            codes = []
            for f in fronts:
                f.eval()
                p = im2col_1d(f(x)[0], lc1.kernel, lc1.stride, lc1.padding)
                p = p[..., None].expand(*p.shape, lc1.dense.c_out)
                codes.append(fake_quant(lc1.dense.q_in, p, lc1.dense.cfg_in, train=False))
            out.append(torch.any(codes[0] != codes[1], dim=(-2, -1)).cpu().numpy())
    return np.concatenate(out)


def bias_gap(layers, wf: np.ndarray, want: np.ndarray, device) -> Dict:
    """The eval forward's window-count sums against ``want``, the lowered
    program's ``run_float`` of ``wf`` (ROADMAP C12).

    With the front's bias on the program's grid the two are one function:
    any difference raises.  With the float bias a front output on a rounding
    tie of lc1's input grid may round the other way, and only the windows
    next to such a site can move (lc1's and lc2's kernels of 3 reach one
    site to either side): a window that moves elsewhere raises.  Returns the
    float bias's gap: ``dq`` (max |d|), ``n_dq`` waveforms it moves, ``n_tie``
    waveforms with a tie site, ``tie_sites`` in all and ``hist``
    {|d|: waveforms}."""
    grid_w = deploy_counts(layers, wf, device)
    deploy = float(np.abs(grid_w.sum(axis=1) - want).max())
    if deploy != 0.0:
        raise ValueError(f"the eval forward with the front's bias on the program's "
                         f"grid != run_float (max|d| {deploy})")
    float_w = eval_counts(layers, wf, device)
    ties = tie_sites(layers, wf, device)
    near = ties.copy()
    near[:, 1:] |= ties[:, :-1]
    near[:, :-1] |= ties[:, 1:]
    if np.any((float_w != grid_w) & ~near):
        raise ValueError("the float bias moved a window that no lc1 input tie reaches")
    gap = np.abs(float_w.sum(axis=1) - want)
    values, n = np.unique(gap[gap != 0], return_counts=True)
    return {"dq": float(gap.max()), "n_dq": int((gap != 0).sum()),
            "n_tie": int(ties.any(axis=1).sum()), "tie_sites": int(ties.sum()),
            "hist": {float(v): int(c) for v, c in zip(values, n)}}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale run: few steps, short waveforms, the "
                         "same train -> lower -> gate -> serve pipeline")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the training step count")
    ap.add_argument("--ctx", type=int, default=None,
                    help="context samples of the lowered program (default "
                         "100; --smoke: 60)")
    ap.add_argument("--verilog", default=None,
                    help="where to write the emitted Verilog (default: "
                         "pid_hybrid.v in the temporary directory)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but no CUDA device is available "
                         "(pass --device cpu for the plain versions)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.ebops import estimate_luts
    from repro_torch.core.lower import lower
    from repro_torch.core.quant import quantize_to_int
    from repro_torch.core.rtl import emit_verilog, verify_rtl
    from repro_torch.models.pid import IN_F, IN_I, build_pid_graph, build_pid_layers
    from repro_torch.serve.api import EngineSpec, build
    from repro_torch.serve.scheduler import MicroBatcher, ServeConfig

    steps = args.steps if args.steps is not None else (8 if args.smoke else 500)
    n_train, n_test = (96, 48) if args.smoke else (1200, 400)
    wf_len = 200 if args.smoke else WF_LEN
    ctx = args.ctx if args.ctx is not None else (60 if args.smoke else 100)
    batch = 64 if args.smoke else BATCH

    wf_tr, cnt_tr, _sp_tr = adc_data(0, n_train, wf_len, "train")
    wf_te, cnt_te, sp_te = adc_data(0, n_test, wf_len, "test")

    # ---------------------------------------------------------------- train
    layers = build_pid_layers(device=device,
                              generator=torch.Generator().manual_seed(0))
    step_fn, init_fn = make_pid_train_step(layers, steps)
    opt = init_fn()
    wf_d = torch.as_tensor(wf_tr, device=device)
    cnt_d = torch.as_tensor(cnt_tr, device=device)
    rng = np.random.default_rng(0)
    t0 = time.monotonic()
    for s in range(steps):
        idx = torch.as_tensor(rng.integers(0, n_train, batch), device=device)
        opt, m = step_fn(opt, wf_d[idx], cnt_d[idx])
        if s % 100 == 0 or s == steps - 1:
            print(f"step {s:4d}  mse={float(m['mse']):.4f}  "
                  f"ebops={float(m['ebops']):.3g}", flush=True)
    print(f"training: {time.monotonic() - t0:.1f}s for {steps} steps of "
          f"{batch} x {wf_len} samples on {device}")

    # ------------------------------------------------------------- evaluate
    pred = eval_counts(layers, wf_te, device)
    with torch.no_grad():
        _, aux = forward(layers, torch.as_tensor(wf_te[:1], device=device))
    s_pred, s_true = separation(pred, sp_te), separation(cnt_te, sp_te)
    eb = float(aux.ebops)
    resid = float(np.abs(pred.sum(1) - cnt_te.sum(1)).mean())
    print(f"separation power: model={s_pred:.3f} (truth-count reference="
          f"{s_true:.3f}); EBOPs={eb:.0f}, est. LUTs={estimate_luts(eb):.0f} "
          f"(paper budget: <10k); mean |count error| per waveform {resid:.2f}")
    if not args.smoke and not s_pred > 0.5 * s_true:
        raise SystemExit("model separation too weak")

    # ------------------------------------------------- lower the hybrid graph
    t0 = time.monotonic()
    prog = lower(build_pid_graph(layers, n_samples=ctx))
    n_cells = sum(t.n_luts() for t in prog.tables.values())
    print(f"DAIS lowering ({ctx}-sample context): {time.monotonic() - t0:.2f}s, "
          f"{prog.n_instrs()} instrs, {len(prog.tables)} shared table sets "
          f"({n_cells} live cells driving {prog.count_ops().get('LLUT', 0)} "
          f"LLUT sites)")

    # --------------------------------------- serving engine behind the gate
    t0 = time.monotonic()
    built = build(prog, EngineSpec(engine="pallas", require="fused",
                                   n_random=256 if args.smoke else 1024,
                                   seed=0), device=device)
    engine, gate = built.engine, built.attestation
    print(f"engine: path={engine.path} ({engine.n_groups} stages, "
          f"{str(engine.dtype).replace('torch.', '')}), bit-exact gate PASSED "
          f"on {gate['random']} random + {gate['exhaustive']} exhaustive rows "
          f"({time.monotonic() - t0:.2f}s)")

    # eval forward vs the compiled integers: with the front's bias on the
    # program's grid they are one function; with the float bias a sum on a
    # rounding tie of lc1's input grid may round the other way (C12)
    ctx_wf = wf_te[:, :ctx]
    try:
        gap = bias_gap(layers, ctx_wf, prog.run_float(ctx_wf)[:, 0], device)
    except ValueError as e:
        raise SystemExit(f"compiled program diverged from the trained model: {e}")
    print(f"eval forward vs DAIS integers on the {ctx}-sample context: equal with the "
          f"front's bias on the program's grid; with its float bias max|d| = "
          f"{gap['dq']:.4g} in {gap['n_dq']} of {len(ctx_wf)} waveforms "
          f"(|d|: waveforms {gap['hist']}), each moved window next to one of "
          f"{gap['tie_sites']} lc1 input ties in {gap['n_tie']} waveforms")

    # -------------------------------------- serve the test codes, bit-exact
    codes = quantize_to_int(ctx_wf, IN_F, IN_I, False, "SAT")
    out = engine.run(codes).cpu().numpy().astype(np.int64)
    if not np.array_equal(out, prog.run(codes)):
        raise SystemExit("served batch diverged from DaisProgram.run")
    print(f"served {len(codes)} test waveforms bit-exactly on path {engine.path}")

    # ----------------------------- serve individual requests, bit-exactly
    with MicroBatcher(engine, ServeConfig(max_batch=16)) as batcher:
        futures = batcher.submit_many(codes)
        out = np.stack([f.result(timeout=120) for f in futures])
        stats = batcher.stats()
    if not np.array_equal(out.astype(np.int64), prog.run(codes)):
        raise SystemExit("scheduler responses diverged from DaisProgram.run")
    print(f"scheduler served {stats.n_requests} waveform requests "
          f"bit-exactly: p50={stats.p50_ms:.2f} ms p99={stats.p99_ms:.2f} ms "
          f"(batches={stats.n_batches})")

    # ------------------------------- emit Verilog + three-way attestation
    verilog = emit_verilog(prog, name="pid_hybrid")
    path = args.verilog or os.path.join(tempfile.gettempdir(), "pid_hybrid.v")
    with open(path, "w") as fh:
        fh.write(verilog)
    print(f"emitted Verilog: {path} ({len(verilog.splitlines())} lines, "
          f"one case-function per shared table cell)")
    t0 = time.monotonic()
    att = verify_rtl(prog, verilog, engine=engine,
                     n_random=64 if args.smoke else 256)
    print(f"RTL simulation: {att['verdict']} three ways (RTL sim == DAIS "
          f"interpreter == {att['engine_path']} engine) over {att['random']} "
          f"random + {att['exhaustive']} exhaustive rows ({att['n_wires']} "
          f"wires, {time.monotonic() - t0:.1f}s)")
    return {"steps": steps, "sep": s_pred, "sep_true": s_true, "ebops": eb,
            "gap": gap, "path": engine.path, "served": len(codes),
            "scheduler": stats,
            "n_instrs": prog.n_instrs(), "rtl": att, "verilog": path}


if __name__ == "__main__":
    main()
