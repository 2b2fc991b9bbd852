"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m bench.run`` from the checkout's root is the same.)  The run
needs as many CUDA cards as the cell asks for; with fewer it exits with
code 3 and prints no result.  It makes its inputs from ``--seed``, sets up
the program (counted as ``setup_s``), measures for ``--seconds``, with
``--trace 1`` profiles a short window after that and reports the cell's
per-layer metrics instead of its end-to-end ones, then checks what the
timed path produced against the plain reference.  The last line on
standard output is the result, a JSON object; the last lines on standard
error are the compared numbers beside their limits.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, the interpreter puts bench/ first on the path, where its
# modules would shadow top-level ones of the same name
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "bench":
    sys.path.pop(0)


def _cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout
    (the program builds its kernels into ``build/`` by itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    _cache_dirs()
    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = harness.resolve(spec, args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s), found {have}; "
              f"no result", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    run = harness.kind(cell).run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench: the run loaded the JAX stack: {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 4
    compared = harness.judge(run["numbers"], cell["limits"])
    print(f"bench: {args.workload} seed {args.seed} on {_power_limit()}; "
          f"set-up {run['setup_s']:.3f} s, window {run['window_s']:.3f} s", file=sys.stderr)
    device_line = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": int(run["memory_peak_bytes"])}
    if args.trace:
        device_line["busy_s"] = run["trace"]["busy_s"]
        device_line["window_s"] = run["trace"]["window_s"]
    result = {"correct": all(c["ok"] for c in compared.values()) and run["failed"] == 0,
              "attempted": int(run["attempted"]), "failed": int(run["failed"]),
              "metrics": harness.read_metrics(
                  harness.metrics_for(spec, args.workload, bool(args.trace)), run),
              "device": device_line}
    if args.trace:
        result["breakdown"] = run["trace"]["breakdown"]
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
