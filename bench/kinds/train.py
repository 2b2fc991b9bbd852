"""The train kind: a model trained through the program's chunked loop.

Set-up makes the inputs from the seed (the family's training set, each
step's rows and the initial state), hands them to the program, and drives
that one loop object (``train/loop.py::chunked_train``, its prefetcher and
its graph chunks) through the first ``checked_steps`` steps: step 0 alone,
in a graph of one step, so that the first gradient can be read from Adam's
state after it; then chunks of ``chunk_steps`` steps, the first of which
captures the graph that the window replays and the next replays it with
fresh rows.  The window pulls chunks from the same loop for ``--seconds``.
After it, the program's state is freed and the family's plain reference
follows the checked steps from the same inputs.

Numbers compared (``compare``), each against its limit in the cell's file:

* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: the first step's gradient as Adam received it (its first
  moment over ``1 - b1``), by the worst leaf: the gap between the
  program's norm and the reference's over the larger of the reference's
  norm and the median leaf's;
* ``change_gap``: the same of each leaf's change over all the checked steps,
  batch-norm stats included; a trainable leaf whose reference gradient is
  under a thousandth of the median leaf's moves by rounding alone under
  Adam and is left out.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from bench import harness

# a leaf whose reference gradient norm is below this share of the median
# leaf's is nought to rounding (a bias under batch-norm): its change is not
# compared
NOUGHT_GRAD = 1e-3


def _norms(tree: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(tree[k].double())) for k in keys}


def _worst(prog: Dict[str, float], ref: Dict[str, float]) -> Dict:
    med = float(np.median(list(ref.values())))
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}
    leaf = max(gaps, key=gaps.get)
    return {"value": gaps[leaf], "leaf": leaf}


def compare(prog: Dict, ref: Dict, state_keys) -> Dict[str, Dict]:
    """The three numbers of the module docstring; ``prog`` and ``ref``
    hold ``losses``, ``grads`` (first step), ``state`` (after the checked
    steps) and ``state0`` (before them)."""
    lp, lr = np.asarray(prog["losses"], np.float64), np.asarray(ref["losses"], np.float64)
    loss = float(np.max(np.abs(lp - lr) / np.abs(lr))) if lp.shape == lr.shape else float("inf")
    keys = sorted(ref["grads"])
    gref = _norms(ref["grads"], keys)
    grad = _worst(_norms(prog["grads"], keys), gref)
    med = float(np.median(list(gref.values())))
    moved = [k for k in keys if gref[k] >= NOUGHT_GRAD * med] + sorted(state_keys)
    delta = lambda side: {k: side["state"][k].double() - ref["state0"][k].double()
                          for k in moved}
    change = _worst(_norms(delta(prog), moved), _norms(delta(ref), moved))
    return {"loss_gap": {"value": loss},
            "grad_gap": grad,
            "change_gap": change,
            "left_out": sorted(set(keys) - set(moved))}


class TrainCell:
    """One train cell's program, loop and inputs on ``device``."""

    def __init__(self, cell: Dict, seed: int, device, mode: Optional[str] = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell["config_data"], cell["traffic_data"]
        self.fam = harness.family(self.cfg)
        self.mode = mode or self.traffic["mode"]
        self.k = self.traffic["chunk_steps"]
        self.checked = self.traffic["checked_steps"]
        if self.checked <= self.k or (self.checked - 1) % self.k:
            raise ValueError(f"checked_steps {self.checked} must be 1 plus a multiple "
                             f"(above 0) of chunk_steps {self.k}")

    # ------------------------------------------------------------ set-up
    def setup(self) -> Dict:
        from repro_torch.kernels import build as kbuild
        from repro_torch.train.loop import chunked_train

        if self.device.type == "cuda":
            kbuild.build_all(self.fam.KERNELS)
        self.data = self.fam.Data(self.cfg, self.traffic, self.seed)
        params, state = self.fam.init_params(self.cfg, self.seed, self.device)
        self.state_keys = sorted(state)
        self.state0 = {k: v.float().cpu().clone() for k, v in {**params, **state}.items()}
        (self.layers, step_fn, self.trained, opt_state,
         b1) = self.fam.build(self.cfg, params, state, self.device)
        del params, state
        stop = (self.checked + self.traffic["trace_chunks"] * self.k
                + int(self.traffic["max_steps_per_s"] * self.cell["seconds"]))
        self.gen = chunked_train(step_fn, self.trained, opt_state, self.data, 0, stop,
                                 chunk_steps=self.k, boundaries=(1,),
                                 prefetch=True, prefetch_depth=self.traffic["prefetch_depth"],
                                 mode=self.mode)
        losses, capture = [], 0.0
        grads = None
        step = 0
        while step < self.checked:
            res = next(self.gen)
            step += res.k
            if res.compiled:
                capture += res.dt_s
            losses += [float(v) for v in res.metrics["loss"]]
            if step == 1:
                grads = {k: (m / (1 - b1)).float().cpu().clone()
                         for k, m in res.opt_state["m"].items()}
            if step == self.checked:
                state = self.fam.state_of(self.layers, self.trained, self.state_keys)
        self.prog = {"losses": losses, "grads": grads, "state": state}
        return {"capture_s": capture}

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> Dict:
        steps, host, failed = 0, 0.0, 0
        t0 = time.perf_counter()
        for res in self.gen:
            steps += res.k
            host += res.host_s
            failed += int(np.sum(~np.isfinite(res.metrics["loss"])))
            if time.perf_counter() - t0 >= seconds:
                break
        return {"window_s": time.perf_counter() - t0, "steps": steps, "host_s": host,
                "failed": failed}

    def chunks(self, n: int) -> int:
        """Pull ``n`` chunks (the traced window); their steps."""
        steps = 0
        for _ in range(n):
            steps += next(self.gen).k
        return steps

    def close(self) -> None:
        """Stop the loop and its prefetcher; free the program's state."""
        gen = getattr(self, "gen", None)
        if gen is not None:
            gen.close()
        self.gen = self.layers = self.trained = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference(self, dtype=torch.float32, half_batch: bool = False) -> Dict:
        """The family's plain reference over the checked steps, from the
        same initial state and rows, on the cell's device."""
        ref_mod = importlib.import_module(f"bench.reference.{self.cell['config']}")
        on = lambda t: t.to(self.device)
        params = {k: on(v) for k, v in self.state0.items() if k not in self.state_keys}
        state = {k: on(v) for k, v in self.state0.items() if k in self.state_keys}
        batches = []
        for s in range(self.checked):
            b = self.data(s)
            batches.append((on(torch.from_numpy(b["x"])), on(torch.from_numpy(b["y"]))))
        out = ref_mod.train(params, state, self.cfg, batches, dtype=dtype,
                            half_batch=half_batch)
        return {"losses": out["losses"], "state0": self.state0,
                "grads": {k: v.cpu() for k, v in out["grads"].items()},
                "state": {k: v.cpu() for k, v in out["state"].items()}}

    def compare(self, ref: Dict, side: Optional[Dict] = None) -> Dict:
        """``side`` (default: the program's readings) against ``ref``."""
        return compare(self.prog if side is None else side, ref, self.state_keys)


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t0: float,
        mode: Optional[str] = None) -> Dict:
    """One run of a train cell: set-up, window, the traced chunks, the check."""
    tc = TrainCell({**cell, "seconds": seconds}, seed, device, mode)
    try:
        setup = tc.setup()
        setup_s = time.perf_counter() - t0
        win = tc.window(seconds)
        traced = None
        if trace:
            from bench.profiling import profile

            n, traced = profile(lambda: tc.chunks(tc.traffic["trace_chunks"]))
            traced["steps"] = n
        peak = (torch.cuda.max_memory_allocated(tc.device)
                if tc.device.type == "cuda" else 0)
    finally:
        tc.close()
    numbers = tc.compare(tc.reference())
    batch = tc.traffic["batch"]
    return {"setup_s": setup_s, **setup, **win, "samples": win["steps"] * batch,
            "batch": batch, "attempted": win["steps"], "memory_peak_bytes": peak,
            "trace": traced, "numbers": numbers,
            "ops_per_sample": tc.fam.train_ops_per_sample(tc.cfg),
            "kernel_bounds": tc.fam.kernel_bounds(tc.cfg, batch)}
