"""Readings that the limits of a cell's compared numbers are set from.

    python3 bench/tools/readings.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 2] > readings.jsonl

For each seed, one JSON line on standard output: the program's numbers
(``sound``: the lower readings), and on the control seeds the numbers of
the plain reference put in the program's place in the next precision down
(``control``: bfloat16 for the train step's float32, the tables' MLPs in
bfloat16 for the scored chain) and of the faults a cell can have
(``faults``: a train step on half of each batch, its state left unchanged,
a graph chunk replayed on the rows it was captured with; a scored answer
altered, half of a batch's answers missing).
A train cell needs no window; a score cell scores ``--seconds`` of its
traffic first.  The benchmark's own runs never run this.  Needs a card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench" / "tools":
    sys.path.pop(0)
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def train_readings(cell, seed, control, device):
    import torch

    from bench.kinds.train import TrainCell
    from bench.tools.faults import stale_graph_batches

    def program():
        tc = TrainCell({**cell, "seconds": 0}, seed, device)
        try:
            tc.setup()
        finally:
            tc.close()
        return tc

    tc = program()
    ref = tc.reference()
    out = {"sound": tc.compare(ref)}
    if control:
        out["control"] = tc.compare(ref, tc.reference(torch.bfloat16))
        out["faults"] = {"half_batch": tc.compare(ref, tc.reference(half_batch=True)),
                         "state_unchanged": tc.compare(ref, {**tc.prog,
                                                             "state": ref["state0"]})}
        if tc.mode == "graph":
            with stale_graph_batches():
                out["faults"]["batch_reused"] = program().compare(ref)
    return out


def score_readings(cell, seed, control, device, seconds):
    import numpy as np
    import torch

    from bench.kinds.score import ScoreCell

    sc = ScoreCell(cell, seed, device)
    try:
        sc.setup()
        sc.loop(seconds=seconds)
    finally:
        sc.close()
    exp = sc.expected()
    out = {"sound": sc.wrong(exp)[0], "rows": len(sc.outputs) * exp.shape[1]}
    if control:
        n_pool = len(exp)
        served = sc.outputs
        ctl = sc.expected(torch.bfloat16)
        sc.outputs = [ctl[n % n_pool][:, None] for n in range(len(served))]
        out["control"] = sc.wrong(exp)[0]
        altered = [o.copy() for o in served]
        altered[len(altered) // 2][0, 0] += 1
        sc.outputs = altered
        out["faults"] = {"answer_altered": sc.wrong(exp)[0]}
        sc.outputs = [o[: len(o) // 2] for o in served]
        out["faults"]["half_batch"] = sc.wrong(exp)[0]
        sc.outputs = served
    return {k: (int(v) if isinstance(v, (int, np.integer)) else v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(harness.load_spec(ROOT), args.workload, ROOT)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    device = torch.device("cuda", 0)
    for seed in [int(s) for s in args.seeds.split(",")]:
        if cell["traffic_data"]["kind"] == "train":
            out = train_readings(cell, seed, seed in controls, device)
        else:
            out = score_readings(cell, seed, seed in controls, device, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
