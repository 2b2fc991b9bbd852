"""The port's mini dry-run: every smoke arch × applicable shape on an 8-rank
``(data=2, model=4)`` mesh of a ``fake`` process group, run once in a
subprocess (``python -m repro_torch.launch.dryrun --all --smoke --mesh
2x4``), so that the fake group never meets another test.

Each cell's per-rank argument bytes equal the arithmetic of the sharding
rules (``spec_for`` -> local shapes) over the parameters (bf16 when
serving), Adam's moments and step, the batch and the decode cache; every
cell counts FLOPs, and a cell whose tensors are sharded issues collectives.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, applicable_shapes, get_config, get_smoke
from repro_torch.models.registry import build_model
from repro_torch.nn.params import flat_defs
from repro_torch.parallel.sharding import batch_dim_spec, local_shape, spec_for

HERE = os.path.dirname(os.path.abspath(__file__))
ENV = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE), "src"),
       "OMP_NUM_THREADS": "1"}
MESH = {"data": 2, "model": 4}
CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.jsonl"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                           "--smoke", "--mesh", "2x4", "--out", str(out)],
                          env=ENV, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"{len(CELLS)} cells OK, 0 failed" in proc.stdout
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    return {(r["arch"], r["shape"]): r for r in rows}


def _bytes(defs, fsdp, dtype=None):
    total = 0
    for d in flat_defs(defs).values():
        n = int(np.prod(local_shape(d.shape, spec_for(d, MESH, fsdp), MESH)))
        dt = dtype if dtype is not None and d.dtype == torch.float32 else d.dtype
        total += n * torch.empty((), dtype=dt).element_size()
    return total


def expected_argument_bytes(arch, shape):
    """Rank 0's argument bytes by the rules' arithmetic alone."""
    cfg = get_smoke(arch)
    spec = SHAPES[shape]
    seq, batch = min(spec.seq_len, 64), min(spec.global_batch, 8)
    model = build_model(cfg, device="meta")
    defs = model.defs()
    total = 0
    for k, v in model.input_specs(seq, batch, spec.mode).items():
        rows = v.shape[0]
        entry = batch_dim_spec(rows, MESH)
        for ax in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            rows //= MESH[ax]
        total += rows * int(np.prod(v.shape[1:])) * torch.empty((), dtype=v.dtype).element_size()
    if spec.mode == "train":
        total += 3 * _bytes(defs, cfg.fsdp) + 4          # params, m, v, step
    else:
        fsdp = bool(cfg.serve_fsdp) if cfg.serve_fsdp >= 0 else cfg.fsdp
        total += _bytes(defs, fsdp, dtype=torch.bfloat16)
    if spec.mode == "decode":
        total += _bytes(model.cache_defs(batch, seq), cfg.fsdp)
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_mini_dryrun_cell(cells, arch, shape):
    r = cells[(arch, shape)]
    assert r["mesh"] == "2x4" and r["n_devices"] == 8
    assert r["argument_size_in_bytes"] == expected_argument_bytes(arch, shape)
    assert r["per_device_bytes"] >= r["argument_size_in_bytes"] > 0
    assert r["flops"] > 0
    assert set(r["coll"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert r["n_collectives"] == sum(v["count"] for v in r["coll"].values()) > 0
    assert r["coll_bytes"] > 0


def test_sp_train_cell_on_a_3d_mesh(tmp_path):
    """SP attention (4 heads on a 16-way ``model`` axis) under a batch
    sharded over ``pod`` and ``data``: the smoke arctic's train cell on a
    ``(2, 2, 16)`` fake mesh.  DTensor cannot split rows that a matmul
    folded from (B, S) when S is sharded too, so the queries' and the
    router logits' gradients are placed as their forward values and the
    output projection is a batched product (ROADMAP C18)."""
    out = tmp_path / "sp.jsonl"
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "arctic_480b", "--shape", "train_4k", "--smoke", "--mesh", "2x2x16",
                           "--out", str(out)],
                          env=ENV, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (r,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert r["mesh"] == "2x2x16" and r["n_devices"] == 64
    assert get_smoke("arctic_480b").n_heads % 16 != 0
    assert r["flops"] > 0 and r["n_collectives"] > 0


PEAK_CODE = """
from torch.distributed._tools.mem_tracker import MemTracker
from repro_torch.configs.base import get_smoke
from repro_torch.launch.dryrun import _meta_inputs, _peak_bytes, init_fake_group
from repro_torch.launch.mesh import mesh_over
from repro_torch.models.registry import build_model
from repro_torch.train import steps
init_fake_group(1)
peaks = {}
for tag in ("none", "mesh"):
    mesh = mesh_over("cpu", (1,), ("data",)) if tag == "mesh" else None
    model = build_model(get_smoke("qwen15_05b"), mesh, device="meta")
    step, _ = steps.make_train_step(model, steps.TrainHParams(), mesh)
    _, opt = steps.init_state(model, mesh)
    batch = _meta_inputs(model, 64, 8, "train")
    batch = steps._shard_inputs(batch, mesh) if mesh is not None else batch
    tracker = MemTracker()
    tracker.track_external(model, *opt["m"].values(), *opt["v"].values(), opt["step"],
                           *batch.values())
    with tracker:
        step(opt, batch)
    peaks[tag] = _peak_bytes(tracker)
print(peaks["mesh"], peaks["none"])
"""


def test_one_device_mesh_step_peaks_as_none():
    """A train step on a one-device mesh holds what the step without one
    holds (``MemTracker`` on meta tensors, the smoke Qwen1.5): within 1%.
    The quantizer once kept each checkpointed layer's DTensor input alive
    (ROADMAP C19), 17% more at this size and 12.3 GB at full width."""
    proc = subprocess.run([sys.executable, "-c", PEAK_CODE], env=ENV, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mesh, none = map(int, proc.stdout.split()[-2:])
    assert none > 0 and mesh <= 1.01 * none, (mesh, none)
