"""The port's mesh code with real collectives on the CPU: 2-process ``gloo``
groups (``tests/_mesh_worker.py``), run in subprocesses so that no process
group leaks into another test of the worker (the 2-rank cases share one
group, run once for the module).

* ``cross_pod_mean`` on a ``(pod=2)`` mesh against the reference's under
  ``shard_map`` on two forced host devices, bit for bit;
* a smoke OLMo and a smoke Phi-3.5-MoE train step on ``(data=2)`` and
  ``(model=2)`` meshes, and the OLMo with one K/V head on ``(model=2)``
  (its K/V whole on each rank), against ``mesh=None`` (float32): loss within 1e-6
  relative, gradients within 1e-5 of their largest while no HGQ code flips,
  flipped activation codes counted and held to phase 15's ``LM_FLIP_FRAC``
  (1e-3): a flip moves the gradients it feeds by more than float32
  rounding, so a step whose codes flip is held to phase 15's gradient
  bounds (1e-3 of the largest, the HGQ widths' 5e-2), and the parameters
  after one Adam step within 2·lr (ROADMAP C6);
* the OLMo step on ``(model=2)`` also against the reference's sharded
  step (its gradients under ``jit`` with the parameter shardings, then
  ``make_train_step(model, mesh)``) on two forced host devices, at the
  cross-package float32 bounds of ``tests/test_torch_lm_models.py``;
* the OLMo with one head on ``(model=2)``: SP attention (K/V and the
  scores sharded along T, the softmax's max and sum reduced over ranks),
  its train step, prefill and decode held as the others;
* prefill and decode of the smoke OLMo on ``(model=2)`` and Phi-3.5-MoE on
  ``(data=2)`` against ``mesh=None``, float32, within 1e-5 of the largest;
* ``compile_program(mesh=)`` on 1- and 2-rank meshes, bit for bit equal to
  ``mesh=None`` and to ``DaisProgram.run``, its ``run_float`` equal to
  ``DaisProgram.run_float``;
* ``sharding.cumsum`` on a DTensor against ``torch.cumsum``;
* ``restore(shardings=)``: a checkpoint of a meshed model back on the mesh;
* ``make_local_mesh("cuda")`` with no card raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_mesh_worker.py")
ENV = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"}
ENV.pop("XLA_FLAGS", None)

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
LM_FLIP_FRAC = 1e-3      # chip_smoke.py's phase-15 bounds
LM_GRAD_RTOL = 1e-3
LM_QGRAD_RTOL = 5e-2


TRAIN = ["train_olmo_data2", "train_olmo_model2", "train_phi_data2", "train_phi_model2",
         "train_olmo_mqa_model2", "train_olmo_sp_model2"]
SERVE_LM = ["serve_olmo_model2", "serve_phi_data2", "serve_olmo_mqa_model2",
            "serve_olmo_sp_model2"]
SERVE_RTOL = 1e-5        # float32 logits and caches, relative to their largest


def run_cases(cases, world, out):
    proc = subprocess.run([sys.executable, WORKER, ",".join(cases), str(world), str(out)],
                          env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank case, run once in one 2-process group."""
    out = tmp_path_factory.mktemp("mesh") / "two.json"
    return {**run_cases(TRAIN + SERVE_LM + ["cross_pod", "serve", "restore", "cumsum"], 2,
                        out),
            "_dir": str(out.parent)}


@pytest.mark.parametrize("case", TRAIN)
def test_train_step_on_a_mesh_against_none(case, two_ranks):
    r = two_ranks[case]
    loss, want = r["loss"]
    assert abs(loss / want - 1) <= LOSS_RTOL, r["loss"]
    assert abs(r["step_loss"][0] / r["step_loss"][1] - 1) <= LOSS_RTOL
    for k, (got, ref) in r["metrics"].items():
        assert abs(got - ref) <= LOSS_RTOL * max(abs(ref), 1e-30), (k, got, ref)
    assert r["n_calls"][0] == r["n_calls"][1]
    assert r["flips"] <= LM_FLIP_FRAC * max(r["n_codes"], 1), (r["flips"], r["n_codes"])
    for k, err in r["grad_err"].items():
        if r["flips"] == 0:
            bound = GRAD_RTOL
        else:
            bound = LM_QGRAD_RTOL if "_q" in k else LM_GRAD_RTOL
        assert err <= bound, (k, err, r["flips"])
    assert r["dp"] <= 2 * r["lr"]
    assert r["opt_step"] == 1 and r["shardings"] == ["opt", "params"]
    # the rules placed every parameter on the 1-D mesh (a Shard somewhere
    # for the sharded ones, never a pending sum)
    assert all(len(p) == 1 and "Partial" not in p[0] for p in r["placements"].values())
    if case.endswith("model2") and "sp" not in case:
        assert r["placements"]["blocks/wq"] == ["Shard(dim=2)"]
    if "sp" in case:    # one head: the heads stay whole, K/V shard along T
        assert r["placements"]["blocks/wq"] == ["Replicate()"]
    if "mqa" in case:   # one K/V head: whole on every rank, queries sharded
        assert r["placements"]["blocks/wk"] == ["Replicate()"]
    if case == "train_olmo_data2":
        assert r["flips"] == 0     # DP alone: every rank's batch rows as before


REF_STEP = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_smoke
from repro.core.ebops import BetaSchedule
from repro.models.registry import build_model
from repro.optim.adam import adam_init
from repro.train import steps

src, dst = sys.argv[1], sys.argv[2]
d = np.load(src)
def nest(prefix):
    out = {}
    for k in d.files:
        if k.startswith(prefix):
            *head, last = k[len(prefix):].split("/")
            node = out
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(d[k])
    return out
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("model",))
model = build_model(dataclasses.replace(get_smoke("olmo_1b"), dtype="float32"), mesh)
hp = steps.TrainHParams(beta=BetaSchedule(beta_init=1e-7, beta_final=None))
ps = steps.param_shardings(model, mesh)
params = jax.device_put(nest("params:"), ps)
batch = {k: jnp.asarray(v) for k, v in nest("batch:").items()}
def objective(p):
    ce, m = model.loss(p, batch)
    return ce + hp.beta(0) * m["ebops"] + hp.moe_aux_coef * m["aux_loss"], m
(loss, met), grads = jax.jit(jax.value_and_grad(objective, has_aux=True),
                             in_shardings=(ps,))(params)
step_fn, shards = steps.make_train_step(model, mesh, hp, donate=False)
new, _, smet = step_fn(params, jax.device_put(adam_init(params), shards["opt"]), batch)
flat = lambda tree, pre="": ({k: v for key, sub in tree.items()
                              for k, v in flat(sub, pre + key + "/").items()}
                             if isinstance(tree, dict) else {pre[:-1]: np.asarray(tree)})
np.savez(dst, loss=np.asarray(loss), step_loss=np.asarray(smet["loss"]),
         **{"metrics:" + k: np.asarray(met[k]) for k in ("ce", "ebops", "aux_loss")},
         **{"grads:" + k: v for k, v in flat(grads).items()},
         **{"stepped:" + k: v for k, v in flat(new).items()},
         n_shards=np.asarray(len(params["embed"].sharding.device_set)))
"""


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / np.sqrt((a @ a) * (b @ b) + 1e-300))


def test_train_step_on_a_mesh_against_the_reference(two_ranks, tmp_path):
    """The port's OLMo step on ``(model=2)`` (two ``gloo`` ranks) against
    the reference's sharded step on two forced host devices, from the same
    parameters and batch: loss and metrics within 1e-5 relative, every
    gradient within 1e-3 of its largest (the HGQ widths 1e-2 and cosine
    >= 0.999), the parameters after one Adam step within 2·lr: the
    float32 bounds the port's unsharded model meets against the
    reference's (``tests/test_torch_lm_models.py``), whose op order and
    fusions differ."""
    assert "train_olmo_model2" in two_ranks
    port = np.load(os.path.join(two_ranks["_dir"], "olmo_model2.npz"))
    out = tmp_path / "ref.npz"
    proc = subprocess.run([sys.executable, "-c", REF_STEP,
                           os.path.join(two_ranks["_dir"], "olmo_model2.npz"), str(out)],
                          env=ENV, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(out)
    assert int(ref["n_shards"]) == 2
    np.testing.assert_allclose(float(port["loss"]), float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(ref["step_loss"]), float(ref["loss"]), rtol=1e-6)
    for k in ("ce", "ebops", "aux_loss"):
        np.testing.assert_allclose(float(port["metrics:" + k]), float(ref["metrics:" + k]),
                                   rtol=1e-5, atol=1e-30, err_msg=k)
    names = sorted(k[len("grads:"):] for k in port.files if k.startswith("grads:"))
    assert names == sorted(k[len("grads:"):] for k in ref.files if k.startswith("grads:"))
    for k in names:
        got, want = port["grads:" + k], ref["grads:" + k]
        err = float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)
        if "_q" in k:
            assert err <= 1e-2 and _cosine(got, want) >= 0.999, (k, err)
        else:
            assert err <= 1e-3, (k, err)
    lr = float(port["lr"])
    for k in names:
        assert float(np.abs(port["stepped:" + k] - ref["stepped:" + k]).max()) <= 2 * lr, k


@pytest.mark.parametrize("case", SERVE_LM)
def test_prefill_and_decode_on_a_mesh_against_none(case, two_ranks):
    """Prefill into a grown cache and two greedy decode steps (the cache
    rows written on each rank's shards, attention on the local heads)."""
    r = two_ranks[case]
    for k in ("prefill", "cache", "decode0", "decode1", "cache_after"):
        assert r[k] <= SERVE_RTOL, (k, r[k])
    assert r["index"] == 26


def test_cross_pod_mean_against_the_reference(two_ranks):
    """The int8 pod hop: each rank's mean and error-feedback state equal
    the reference's ``cross_pod_mean`` inside ``shard_map`` on two forced
    CPU devices, bit for bit."""
    got = two_ranks["cross_pod"]["per_rank"]
    code = f"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax
from jax.sharding import PartitionSpec as P
sys.path.insert(0, {HERE!r})
from _mesh_data import pod_grads, pod_errs
from repro.optim.compress import cross_pod_mean
mesh = jax.make_mesh((2,), ("pod",))
stack = lambda f: jax.tree.map(lambda *a: np.stack(a), f(0), f(1))
def body(g, e):
    g = jax.tree.map(lambda t: t[0], g)
    e = jax.tree.map(lambda t: t[0], e)
    m, ne = cross_pod_mean(g, e, mesh)
    return jax.tree.map(lambda t: t[None], m), jax.tree.map(lambda t: t[None], ne)
fn = jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                   out_specs=(P("pod"), P("pod")))
m, e = fn(stack(pod_grads), stack(pod_errs))
print(json.dumps([{{"mean": jax.tree.map(lambda t: np.asarray(t)[r].tolist(), m),
                   "err": jax.tree.map(lambda t: np.asarray(t)[r].tolist(), e)}}
                  for r in range(2)]))
"""
    proc = subprocess.run([sys.executable, "-c", code], env=ENV, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for r in range(2):
        for part in ("mean", "err"):
            for key, a, b in (("a", got[r][part]["a"], want[r][part]["a"]),
                              ("b/c", got[r][part]["b"]["c"], want[r][part]["b"]["c"])):
                a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), (r, part, key)
    # the mean is the same on both pods; the error feedback is each pod's own
    assert got[0]["mean"] == got[1]["mean"]
    assert got[0]["err"] != got[1]["err"]


@pytest.mark.parametrize("world", [1, 2])
def test_compile_program_on_a_mesh_bit_exact(world, two_ranks, tmp_path):
    if world == 2:
        r = two_ranks["serve"]
    else:
        r = run_cases(["serve"], 1, tmp_path / "one.json")["serve"]
    assert set(r) == {"pallas", "fused", "groups"}
    for name, got in r.items():
        assert got["equal"] and got["interp"] and got["mesh"] and got["float"], (name, got)
    assert r["groups"]["path"] == "generic"


def test_cumsum_on_a_dtensor(two_ranks):
    """The SSD/WKV chunks' cumsum on a DTensor: its value bit for bit, its
    gradient (a suffix sum without ``flip``) within float32 rounding of
    torch's."""
    r = two_ranks["cumsum"]
    assert r["value"] == 0.0
    assert r["grad"] <= 1e-6, r


def test_restore_with_shardings_round_trip(two_ranks):
    r = two_ranks["restore"]
    assert r == {"params_equal": True, "placed": True, "moments_equal": True,
                 "step": 1, "manifest_step": 1}


def test_make_local_mesh_cuda_without_a_card_raises():
    code = """
import torch
from repro_torch.launch import mesh
try:
    mesh.make_local_mesh("cuda")
except RuntimeError as e:
    print("raised:", e)
else:
    print("no error")
import torch.distributed as dist
print("group:", dist.is_initialized())
"""
    proc = subprocess.run([sys.executable, "-c", code], env={**ENV, "CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "raised: make_local_mesh('cuda'): no CUDA device" in proc.stdout
    assert "group: False" in proc.stdout
