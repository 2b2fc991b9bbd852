"""Multi-process ``gloo`` cases of the port's mesh code, run by
``tests/test_torch_mesh.py`` in a subprocess so that no process group
outlives a test.

    python tests/_mesh_worker.py CASE[,CASE...] WORLD OUT.json

starts WORLD ranks (``torch.multiprocessing``, ``file://`` rendezvous in a
temporary directory) that run the cases in order in one process group;
rank 0 writes ``{case: result}`` to OUT.json, and the cases that dump
arrays for a comparison with the reference write them beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(os.path.dirname(HERE), "src")]


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


# ------------------------------------------------------------- train step
def _record_fake_quant():
    """Patch the GLU/MLP quantizer to record each output (whole)."""
    import repro_torch.nn.mlp as mlpm

    seen, orig = [], mlpm.fake_quant

    def rec(qp, x, cfg, train=True):
        out = orig(qp, x, cfg, train=train)
        seen.append(_whole(out.detach()).float().clone())
        return out

    mlpm.fake_quant = rec
    return seen, lambda: setattr(mlpm, "fake_quant", orig)


def _dump(name, **arrays):
    """Rank 0 writes ``arrays`` (flat numpy dicts by reference path, or
    arrays) to ``$MESH_DUMP_DIR/name.npz`` for a comparison with the
    reference outside this process."""
    where = os.environ.get("MESH_DUMP_DIR")
    if not where or dist.get_rank() != 0:
        return
    flat = {}
    for key, val in arrays.items():
        if isinstance(val, dict):
            flat.update({f"{key}:{k}": np.asarray(v) for k, v in val.items()})
        else:
            flat[key] = np.asarray(val)
    np.savez(os.path.join(where, name + ".npz"), **flat)


def case_train(arch, shape, names, dump=None, **over):
    from repro_torch import interop
    from repro_torch.configs.base import get_smoke
    from repro_torch.core.ebops import BetaSchedule
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models.registry import build_model
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    mesh = _mesh(shape, names)
    hp = steps.TrainHParams(beta=BetaSchedule(beta_init=1e-7, beta_final=None))
    ref = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mm = build_model(cfg, mesh, generator=torch.Generator().manual_seed(0))
    ref0 = (build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
            if dump else None)
    nb = lm_batch(3, 0, 4, 32, cfg.vocab)
    batch = {k: torch.as_tensor(v) for k, v in nb.items()}
    zero = torch.zeros((), dtype=torch.int32)

    seen_ref, undo = _record_fake_quant()
    loss_r, met_r, g_r = steps.lm_loss_and_grads(ref, hp, zero, batch)
    undo()
    steps.init_state(mm, mesh)
    seen_m, undo = _record_fake_quant()
    with shd.mesh_context(mesh):
        loss_m, met_m, g_m = steps.lm_loss_and_grads(
            mm, hp, zero, steps._shard_inputs(batch, mesh))
    undo()
    flips = sum(int((a != b).sum()) for a, b in zip(seen_ref, seen_m))
    n_codes = sum(a.numel() for a in seen_ref)
    grad_err = {k: float((_whole(g_m[k]) - g).abs().max() / max(float(g.abs().max()), 1e-30))
                for k, g in g_r.items()}
    placed = {k: [repr(p) for p in v.placements] for k, v in mm.flat_params().items()}

    step_r, _ = steps.make_train_step(ref, hp)
    step_m, shards = steps.make_train_step(mm, hp, mesh)
    _, opt_r = steps.init_state(ref)
    _, opt_m = steps.init_state(mm, mesh)
    _, mr = step_r(opt_r, batch)
    opt_m, mm_met = step_m(opt_m, batch)
    dp = max(float((_whole(p.detach()) - ref.get_parameter(k).detach()).abs().max())
             for k, p in mm.flat_params().items())
    if dump:   # the initial parameters, the batch and the mesh step's results
        _dump(dump, params=interop.unnest(interop.lm_params_to_numpy(ref0)), batch=nb,
              loss=float(_whole(loss_m)),
              metrics={k: float(_whole(v)) for k, v in met_m.items()},
              grads={k: _whole(g).numpy() for k, g in g_m.items()},
              stepped={k: _whole(p.detach()).numpy() for k, p in mm.flat_params().items()},
              lr=hp.adam.lr)
    return {"loss": [float(_whole(loss_m)), float(loss_r)],
            "step_loss": [float(mm_met["loss"]), float(mr["loss"])],
            "metrics": {k: [float(_whole(met_m[k])), float(met_r[k])] for k in met_r},
            "grad_err": grad_err, "flips": flips, "n_codes": n_codes,
            "n_calls": [len(seen_m), len(seen_ref)], "dp": dp, "lr": hp.adam.lr,
            "placements": placed, "opt_step": int(_whole(opt_m["step"])),
            "shardings": sorted(shards)}


def case_serve_lm(arch, shape, names, **over):
    """Prefill and two greedy decode steps of a float32 smoke model on a
    mesh and without one: the largest logit and cache differences, each
    relative to its largest value."""
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    mesh = _mesh(shape, names)
    ref = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mm = build_model(cfg, mesh, generator=torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (4, 24)),
                           dtype=torch.int32)
    rel = lambda a, b: float((_whole(a) - b).abs().max() / max(float(b.abs().max()), 1e-30))
    lr, cr = steps.make_prefill(ref)({"tokens": toks}, 27)
    lm, cm = steps.make_prefill(mm, mesh)({"tokens": toks}, 27)
    out = {"prefill": rel(lm, lr), "cache": max(rel(cm[k], cr[k]) for k in ("k", "v"))}
    dr, dm = steps.make_decode_step(ref), steps.make_decode_step(mm, 4, 27, mesh)
    for i in range(2):
        tok = torch.argmax(lr, dim=-1).to(torch.int32)
        lr, cr = dr(cr, tok)
        lm, cm = dm(cm, tok)
        out[f"decode{i}"] = rel(lm, lr)
    out["cache_after"] = max(rel(cm[k], cr[k]) for k in ("k", "v"))
    out["index"] = int(_whole(cm["index"]))
    return out


def case_cumsum():
    """``sharding.cumsum`` on a DTensor sharded along another dim: value and
    gradient against ``torch.cumsum`` on the whole tensor."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.parallel import sharding as shd

    mesh = _mesh((dist.get_world_size(),), ("model",))
    x = torch.randn(4, 6, 16, generator=torch.Generator().manual_seed(3))
    w = torch.randn(4, 6, 16, generator=torch.Generator().manual_seed(4))
    ref = x.clone().requires_grad_(True)
    (torch.cumsum(ref, dim=-1) * w).sum().backward()
    xd = distribute_tensor(x, mesh, [Shard(1)]).requires_grad_(True)
    yd = shd.cumsum(xd, -1)
    (yd * distribute_tensor(w, mesh, [Shard(1)])).sum().backward()
    return {"value": float((yd.detach().full_tensor() - torch.cumsum(x, dim=-1)).abs().max()),
            "grad": float((xd.grad.full_tensor() - ref.grad).abs().max()
                          / ref.grad.abs().max())}


# ---------------------------------------------------------- cross-pod mean
def _tree(fn, t):
    return {k: _tree(fn, v) for k, v in t.items()} if isinstance(t, dict) else fn(t)


def case_cross_pod():
    from _mesh_data import pod_errs, pod_grads
    from repro_torch.optim.compress import cross_pod_mean

    mesh = _mesh((dist.get_world_size(),), ("pod",))
    rank = dist.get_rank()
    g = _tree(torch.as_tensor, pod_grads(rank))
    e = _tree(torch.as_tensor, pod_errs(rank))
    mean, err = cross_pod_mean(g, e, mesh)
    out = {"mean": _tree(lambda t: t.numpy().tolist(), mean),
           "err": _tree(lambda t: t.numpy().tolist(), err)}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return {"per_rank": gathered}


# ----------------------------------------------------------------- serving
def case_serve():
    from repro_torch.core.lower import compile_sequential
    from repro_torch.kernels.lut_serve import compile_program, input_code_bounds
    from repro_torch.launch.serve import build_lut_stack

    layers = build_lut_stack([16, 20, 5], 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    prog = compile_sequential(layers, 4, 2)
    lo, hi = input_code_bounds(prog)
    codes = np.random.default_rng(0).integers(lo, hi + 1, (64, len(prog.input_f)))
    mesh = _mesh((dist.get_world_size(),), ("data",))
    # floats off the input grid, some on its ties (rounded half to even,
    # staying in range): run_float rounds them onto it
    off = np.random.default_rng(1).choice([-0.5, -0.3, 0.0, 0.25, 0.45], codes.shape)
    off = np.where((off == -0.5) & (codes == lo), 0.0, off)
    xf = (codes + off) * np.exp2(-np.asarray(prog.input_f, np.float64))
    out = {}
    for name in ("pallas", "fused", "groups"):
        plain = compile_program(prog, device="cpu", engine=name).run(codes)
        meshed = compile_program(prog, mesh=mesh, device="cpu", engine=name)
        got = meshed.run(codes)
        out[name] = {"equal": bool(torch.equal(plain, got)), "mesh": meshed.mesh is mesh,
                     "path": meshed.path,
                     "interp": bool(np.array_equal(got.numpy(), prog.run(codes))),
                     "float": bool(np.array_equal(meshed.run_float(xf), prog.run_float(xf)))}
    return out


# -------------------------------------------------------------- checkpoints
def case_restore():
    from repro_torch.ckpt.store import CheckpointStore
    from repro_torch.configs.base import get_smoke
    from repro_torch.models.registry import build_model
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_smoke("qwen15_05b"), dtype="float32")
    mesh = _mesh((dist.get_world_size(),), ("data",))
    src = build_model(cfg, mesh, generator=torch.Generator().manual_seed(1))
    step, _ = steps.make_train_step(src, steps.TrainHParams(), mesh)
    _, opt = steps.init_state(src, mesh)
    from repro_torch.data.synthetic import lm_batch
    opt, _ = step(opt, {k: torch.as_tensor(v) for k, v in
                        lm_batch(0, 0, 4, 32, cfg.vocab).items()})
    # every rank saves (the whole arrays are gathered collectively), each
    # into its own directory
    mgr = CheckpointStore(os.path.join(os.environ["MESH_CKPT_DIR"], str(dist.get_rank())))
    mgr.save(1, src, opt)
    mgr.wait()
    dst = build_model(cfg, mesh, generator=torch.Generator().manual_seed(2))
    shards = steps.param_shardings(dst, mesh)
    _, opt0 = steps.init_state(dst, mesh)
    dst, opt2, manifest = mgr.restore(dst, opt0, shardings=shards)
    same = all(torch.equal(_whole(p.detach()), _whole(src.get_parameter(k).detach()))
               for k, p in dst.flat_params().items())
    placed = all(list(p.placements) == list(shards[k]) for k, p in dst.flat_params().items())
    moments = all(torch.equal(_whole(opt2[mv][k]), _whole(opt[mv][k]))
                  and list(opt2[mv][k].placements) == list(shards[k])
                  for mv in ("m", "v") for k in shards)
    return {"params_equal": same, "placed": placed, "moments_equal": moments,
            "step": int(_whole(opt2["step"])), "manifest_step": manifest["step"]}


CASES = {
    "train_olmo_data2": lambda: case_train("olmo_1b", (2,), ("data",)),
    "train_olmo_model2": lambda: case_train("olmo_1b", (2,), ("model",), dump="olmo_model2"),
    "train_phi_data2": lambda: case_train("phi35_moe", (2,), ("data",)),
    "train_phi_model2": lambda: case_train("phi35_moe", (2,), ("model",)),
    # one K/V head: replicated along model while the queries shard
    "train_olmo_mqa_model2": lambda: case_train("olmo_1b", (2,), ("model",), n_kv_heads=1),
    # one head on a 2-way model axis: SP attention, K/V sharded along T
    "train_olmo_sp_model2": lambda: case_train("olmo_1b", (2,), ("model",), n_heads=1,
                                               n_kv_heads=1),
    "serve_olmo_model2": lambda: case_serve_lm("olmo_1b", (2,), ("model",)),
    "serve_olmo_sp_model2": lambda: case_serve_lm("olmo_1b", (2,), ("model",), n_heads=1,
                                                  n_kv_heads=1),
    "serve_olmo_mqa_model2": lambda: case_serve_lm("olmo_1b", (2,), ("model",), n_kv_heads=1),
    "serve_phi_data2": lambda: case_serve_lm("phi35_moe", (2,), ("data",)),
    "cross_pod": case_cross_pod,
    "cumsum": case_cumsum,
    "serve": case_serve,
    "restore": case_restore,
}


def _run(rank, world, case, out, init):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        result = {c: CASES[c]() for c in case.split(",")}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def main():
    case, world, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        os.environ.setdefault("MESH_CKPT_DIR", os.path.join(tmp, "ckpt"))
        os.environ.setdefault("MESH_DUMP_DIR", os.path.dirname(os.path.abspath(out)))
        torch.multiprocessing.spawn(_run, args=(world, case, out, init), nprocs=world)


if __name__ == "__main__":
    main()
