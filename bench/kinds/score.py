"""The score kind: whole inputs scored by a compiled program, closed loop.

Set-up makes the weights and a pool of ``pool_batches`` host batches from
the seed, hands the weights to the program, which lowers and builds its
engine, and runs every pool batch through the engine once (the cell's only
shape).  The window is one caller: it hands batch ``n`` (pool batch ``n mod
pool_batches``, as host numpy codes) to ``engine.run``, takes the outputs
to the host, and only then sends the next, for ``--seconds``.  Each batch's
latency runs from the call to its outputs as host numpy.

After the window the engine is freed and the family's plain reference
works out every pool batch's outputs from the weights; every output of
every batch scored in the window (and in the traced window) is compared
with them.  ``wrong_outputs`` counts the rows whose output differs or never
came; its limit is 0.
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict

import numpy as np
import torch

from bench import harness, warm


class ScoreCell:
    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell["config_data"], cell["traffic_data"]
        self.fam = harness.family(self.cfg)
        self.ref = importlib.import_module(f"bench.reference.{cell['config']}")

    def setup(self) -> Dict:
        from repro_torch.kernels import build as kbuild

        if self.device.type == "cuda":
            kbuild.build_all(self.fam.KERNELS)
        self.params = self.fam.init_params(self.cfg, self.seed, self.device)
        self.pool = self.fam.pool(self.cfg, self.traffic, self.seed)
        self.engine, timings = self.fam.build(self.cfg, self.params, self.traffic["ctx"],
                                              self.device)
        for x in self.pool:
            self.engine.run(x).cpu()
        self.outputs = []
        return {"build_s": timings}

    def loop(self, seconds: float = None, batches: int = None) -> Dict:
        """Score batches back to back until ``seconds`` have passed or
        ``batches`` were scored; every output is kept for the check."""
        lat, host = [], []
        n_pool = len(self.pool)
        t0 = time.perf_counter()
        t = t0
        while True:
            x = self.pool[len(self.outputs) % n_pool]
            t1 = time.perf_counter()
            y = self.engine.run(x)
            t2 = time.perf_counter()
            out = y.cpu().numpy()
            t = time.perf_counter()
            self.outputs.append(out)
            lat.append(t - t1)
            host.append(t2 - t1)
            if (seconds is not None and t - t0 >= seconds) or len(lat) == batches:
                break
        return {"window_s": t - t0, "latency_s": lat, "host_s": host}

    def close(self) -> None:
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def expected(self, dtype=torch.float32) -> np.ndarray:
        """(pool_batches, batch) output codes by the plain reference."""
        prep = self.ref.prepare(self.params, self.cfg, dtype)
        codes = torch.as_tensor(self.pool.reshape(-1, self.pool.shape[-1]),
                                device=self.device)
        out = self.ref.forward(codes, prep, self.cfg, block=self.traffic["ref_block"])
        return out.cpu().numpy().reshape(self.pool.shape[:2])

    def wrong(self, expected: np.ndarray):
        """Rows of the scored batches whose output is not the expected
        code (a missing or misshapen batch counts all its rows), and the
        batches that hold any."""
        n_pool, b = expected.shape
        rows = batches = 0
        for n, out in enumerate(self.outputs):
            want = expected[n % n_pool]
            bad = b if out.shape != (b, 1) else int(np.sum(out[:, 0].astype(np.int64) != want))
            rows += bad
            batches += bad > 0
        return rows, batches

    def chain_ops(self) -> Dict:
        prep = self.ref.prepare(self.params, self.cfg)
        from bench.counts import roofline as rl

        ctx, b = self.traffic["ctx"], self.traffic["batch"]
        ops_row = rl.pid_chain_ops(self.ref.chain_stages(prep, self.cfg, ctx))
        tb = self.ref.table_bytes(prep, self.params, self.cfg)
        return {"ops_per_row": ops_row,
                "kernel_bounds": {"lut_serve": rl.b4(b, ctx, 1, tb, ops_row)[0]}}


def run(cell: Dict, seed: int, seconds: float, trace: bool, device, t0: float) -> Dict:
    sc = ScoreCell(cell, seed, device)
    try:
        setup = sc.setup()
        peak0 = warm.link(sc.device)
        setup_s = time.perf_counter() - t0
        win = sc.loop(seconds=seconds)
        n_window = len(sc.outputs)
        traced = None
        if trace:
            from bench.profiling import profile

            n = sc.traffic["trace_batches"]
            _, traced = profile(lambda: sc.loop(batches=n))
            traced["batches"] = n
        peak = max(peak0, torch.cuda.max_memory_allocated(sc.device)
                   if sc.device.type == "cuda" else 0)
    finally:
        sc.close()
    wrong, failed = sc.wrong(sc.expected())
    b = sc.traffic["batch"]
    lat = np.asarray(win["latency_s"])
    return {"setup_s": setup_s, **setup, **win, **sc.chain_ops(),
            "rows": n_window * b, "batches": n_window, "batch": b,
            "attempted": len(sc.outputs), "failed": failed,
            "latency_p95_s": float(np.percentile(lat, 95)),
            "memory_peak_bytes": peak, "trace": traced,
            "numbers": {"wrong_outputs": {"value": float(wrong)}}}
