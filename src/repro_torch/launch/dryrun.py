"""Multi-pod dry-run: build and run every (arch × shape × mesh) cell on
``meta`` tensors under a ``fake`` process group (port of
``repro.launch.dryrun``).

The reference forces 512 CPU devices and lowers and compiles each cell with
XLA.  Here ``main`` makes a ``fake`` process group of 512 ranks first (the
reference sets ``XLA_FLAGS`` first), this process playing rank 0; every cell
builds its step exactly as the launchers do (``build_model(cfg, mesh,
device="meta")``, the same sharding rules, ``train/steps.py``'s factories),
places the parameters, Adam state, batch and caches as DTensors of ``meta``
tensors, and runs the step once.  Nothing is allocated and no collective
moves data, so every figure is a count for a hypothetical fleet of 256 or
512 ranks, not a measurement.  Each cell records

* ``argument_size_in_bytes``: rank 0's bytes of its arguments, from the
  local shapes of the parameters, Adam's ``m``/``v``/``step``, the batch
  and (decode) the cache;
* ``per_device_bytes``: rank 0's peak bytes over the step, from
  ``torch.distributed._tools.mem_tracker.MemTracker`` (arguments, outputs
  and temporaries alive at once; the reference divides XLA's
  ``memory_analysis`` figures by the device count instead);
* ``flops``: rank 0's FLOPs, counted on the local ops below DTensor (a
  ``FlopCounterMode`` above DTensor counts the global product);
* ``coll``: the functional collectives the step issues on rank 0, by kind
  (all-gather, all-reduce, reduce-scatter, all-to-all), with their count
  and result bytes; ``coll_bytes`` their sum and ``n_collectives`` the
  count;
* ``wall_s``: the cell's seconds on this host.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out results/dryrun.jsonl

Not in the reference: ``--arch`` takes a comma-separated list, ``--mesh
2x4`` runs on a small ``(data, model)`` mesh (``(pod, data, model)`` with
three sizes), and ``--smoke`` takes each arch's smoke config at a sequence
of at most 64 and a batch of at most 8: the CPU tests' mini dry-run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")


def _kind(func) -> Optional[str]:
    name = str(func)
    for kind, keys in (("all-gather", ("all_gather", "allgather")),
                       ("reduce-scatter", ("reduce_scatter",)),
                       ("all-reduce", ("all_reduce", "allreduce")),
                       ("all-to-all", ("all_to_all", "alltoall"))):
        if any(k in name for k in keys):
            return kind
    return None


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


class LocalCounter(TorchDispatchMode):
    """FLOPs and collectives of the ops a rank runs on its local tensors.

    Ops on DTensors are handed back to DTensor (``NotImplemented``), which
    runs them as local ops and collectives that come back through here, so
    the counts are per rank.  The shape inference DTensor runs on fake
    tensors of the global shapes (once per new sharding of an op) runs
    uncounted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0
        self.coll = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        kind = _kind(func)
        if kind is not None and "wait" not in str(func):
            self.coll[kind]["count"] += 1
            self.coll[kind]["bytes"] += _nbytes(out)
        return out


def _local_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    t = tree.to_local() if hasattr(tree, "to_local") else tree
    return t.numel() * t.element_size()


def _meta_inputs(model, seq: int, batch: int, mode: str) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in model.input_specs(seq, batch, mode).items()}


def _to_bf16(model) -> None:
    """Serving runs from bf16 checkpoints: every float32 parameter as bf16."""
    for path, p in model.flat_params().items():
        if p.dtype == torch.float32:
            model.register_parameter(path, torch.nn.Parameter(
                torch.empty(p.shape, dtype=torch.bfloat16, device="meta"),
                requires_grad=False))


def _peak_bytes(tracker) -> int:
    peak = tracker.get_tracker_snapshot("peak")
    return int(max((v.get("Total", 0) for v in peak.values()), default=0))


def parse_mesh(text: str):
    """``"2x4"`` -> ((2, 4), ("data", "model")); three sizes add "pod"."""
    shape = tuple(int(d) for d in text.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if names is None:
        raise ValueError(f"--mesh {text!r}: give two or three sizes")
    return shape, names


def make_mesh(multi_pod: bool, small=None):
    """The cell's mesh over the first ranks of the fake world."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_over

    if small is not None:
        return mesh_over("cpu", *small)
    return make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape: str, multi_pod: bool, *, small=None, smoke: bool = False,
             verbose: bool = True) -> Dict:
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.configs.base import SHAPES, get_config, get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps as steps_mod

    t0 = time.time()
    cfg = get_smoke(arch) if smoke else get_config(arch)
    spec = SHAPES[shape]
    seq, batch = spec.seq_len, spec.global_batch
    if smoke:   # the smoke widths take the smoke cell's sizes
        seq, batch = min(seq, 64), min(batch, 8)
    mesh = make_mesh(multi_pod, small)
    model = build_model(cfg, mesh, device="meta")
    inputs = _meta_inputs(model, seq, batch, spec.mode)
    counter, tracker = LocalCounter(), MemTracker()

    if spec.mode == "train":
        step_fn, _ = steps_mod.make_train_step(model, steps_mod.TrainHParams(), mesh)
        params, opt = steps_mod.init_state(model, mesh)
        batch_in = steps_mod._shard_inputs(inputs, mesh)
        args = {"params": params, "opt": opt, "batch": batch_in}
        tracker.track_external(model, *opt["m"].values(), *opt["v"].values(),
                               opt["step"], *batch_in.values())
        with tracker, counter:
            step_fn(opt, batch_in)
    elif spec.mode == "prefill":
        _to_bf16(model)
        fn = steps_mod.make_prefill(model, mesh)
        batch_in = steps_mod._shard_inputs(inputs, mesh)
        args = {"params": model.flat_params(), "batch": batch_in}
        tracker.track_external(model, *batch_in.values())
        with tracker, counter:
            fn(batch_in)
    else:  # decode
        _to_bf16(model)
        fn = steps_mod.make_decode_step(model, batch=batch, t=seq, mesh=mesh)
        with shd.mesh_context(mesh):
            cache = model._zero_cache(batch, seq)
        tokens = steps_mod._shard_inputs(inputs, mesh)["tokens"]
        args = {"params": model.flat_params(), "cache": cache, "batch": {"tokens": tokens}}
        tracker.track_external(model, *cache.values(), tokens)
        with tracker, counter:
            fn(cache, tokens)

    n_dev = mesh.size()
    coll = {k: dict(v) for k, v in counter.coll.items()}
    result = {
        "arch": arch, "shape": shape,
        "mesh": "x".join(map(str, mesh.shape)),
        "n_devices": n_dev,
        "flops": float(counter.flops),                      # per rank
        "coll_bytes": float(sum(v["bytes"] for v in coll.values())),   # per rank
        "coll": coll,
        "n_collectives": sum(v["count"] for v in coll.values()),
        "argument_size_in_bytes": _local_bytes(args),       # per rank
        "per_device_bytes": _peak_bytes(tracker),           # per rank, peak
        "wall_s": round(time.time() - t0, 1),
    }
    if verbose:
        print(f"[dryrun] {arch:15s} {shape:12s} mesh={result['mesh']:9s} "
              f"flops/rank={result['flops']:.3e} args/rank={result['argument_size_in_bytes']:.3e} "
              f"peak/rank={result['per_device_bytes']:.3e} "
              f"coll/rank={result['coll_bytes']:.3e} ({result['n_collectives']}) "
              f"{result['wall_s']:.0f}s", flush=True)
    return result


def init_fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=world)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--mesh", default=None,
                    help="a small mesh instead, e.g. 2x4 (data, model) or 2x2x2")
    ap.add_argument("--smoke", action="store_true", help="each arch's smoke config")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import ARCH_IDS, applicable_shapes, get_config

    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in applicable_shapes(get_config(a)):
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        cells = [(a, args.shape) for a in args.arch.split(",")]

    small = parse_mesh(args.mesh) if args.mesh else None
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if small is not None:
        meshes = [False]
    world = 1
    for d in (small[0] if small else (2, 16, 16) if True in meshes else (16, 16)):
        world *= d
    init_fake_group(world)

    results, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            try:
                r = run_cell(arch, shape, mp, small=small, smoke=args.smoke)
                results.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
            except Exception as e:  # noqa: BLE001 — report, keep sweeping
                failures.append((arch, shape, mp, repr(e)[:300]))
                print(f"[dryrun] FAIL {arch} {shape} multi_pod={mp}: {e!r}",
                      file=sys.stderr)
    print(f"\n[dryrun] {len(results)} cells OK, {len(failures)} failed")
    for f in failures:
        print("  FAIL:", *f)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
