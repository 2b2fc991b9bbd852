"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
reference's (``repro.parallel.sharding``).

* ``spec_for`` on every PDef of every config in ``ARCH_IDS``: the
  parameters, and the decode caches of each applicable decode shape, at
  both production meshes' sizes, with ``fsdp`` off and on and the
  config's training and serving profiles;
* the reference's own cases (``tests/test_sharding.py``), one
  parametrised test;
* ``batch_dim_spec``, ``act_spec``, ``batch_axes`` and ``heads_shardable``
  through a stand-in with the ``axis_names`` and ``devices`` of each
  production mesh (all those functions read);
* the local shapes of ``param_shardings`` placements on a ``fake``-group
  mesh equal the spec's arithmetic (in a subprocess).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import get_config as ref_config
from repro.models.registry import build_model as ref_build
from repro.nn.params import PDef as RefPDef
from repro.parallel import sharding as ref
from repro_torch.configs.base import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.models.registry import build_model
from repro_torch.nn.params import PDef, flat_defs
from repro_torch.parallel import sharding as shd

AXES = {"data": 16, "model": 16}
AXES_POD = {"pod": 2, "data": 16, "model": 16}
MESHES = {"16x16": AXES, "2x16x16": AXES_POD}


def _ref_flat(defs, prefix=""):
    if isinstance(defs, RefPDef):
        return {prefix: defs}
    out = {}
    for k, v in defs.items():
        out.update(_ref_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _pairs(arch):
    """(what, port PDefs by path, reference PDefs by path) of an arch:
    its parameters and each decode shape's cache."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    port, refm = build_model(cfg, device="meta"), ref_build(rcfg)
    out = [("params", flat_defs(port.defs()), _ref_flat(refm.defs()))]
    for s in applicable_shapes(cfg):
        spec = SHAPES[s]
        if spec.mode == "decode":
            out.append((f"cache {s}", flat_defs(port.cache_defs(spec.global_batch, spec.seq_len)),
                        _ref_flat(refm.cache_defs(spec.global_batch, spec.seq_len))))
    return cfg, out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_equals_the_reference_on_every_pdef(arch, mesh):
    axes = MESHES[mesh]
    cfg, pairs = _pairs(arch)
    profiles = {False, True, cfg.fsdp}
    if cfg.serve_fsdp >= 0:
        profiles.add(bool(cfg.serve_fsdp))
    n = 0
    for what, port, refd in pairs:
        assert list(port) == list(refd), (what, sorted(set(port) ^ set(refd)))
        for path, d in port.items():
            r = refd[path]
            assert tuple(d.shape) == tuple(r.shape) and tuple(d.axes) == tuple(r.axes)
            for fsdp in profiles:
                got = shd.spec_for(d, axes, fsdp)
                assert got == tuple(ref.spec_for(r, axes, fsdp)), (what, path, fsdp, got)
                n += 1
    assert n > 0


def test_every_arch_has_a_reference_config():
    assert set(ARCH_IDS) == {a for a in ARCH_IDS if ref_config(a).name == get_config(a).name}
    assert set(SHAPES) == set(REF_SHAPES)


# the reference's own cases (tests/test_sharding.py), as data
CASES = [
    ("tp_heads", (16, 2048, 16, 128), ("layers", "embed", "heads", None), AXES, False,
     (None, None, "model", None)),
    ("tp_vocab", (50304, 2048), ("vocab", "embed"), AXES, False, ("model", None)),
    ("kv_heads_replicated", (40, 5120, 8, 128), ("layers", "embed", "kv_heads", None), AXES,
     False, (None, None, None, None)),
    ("kv_heads_sharded", (16, 2048, 16, 128), ("layers", "embed", "kv_heads", None), AXES,
     False, (None, None, "model", None)),
    ("fsdp_embed", (35, 7168, 4864), ("layers", "embed", "ffn"), AXES, True,
     (None, "data", "model")),
    ("no_fsdp_embed", (35, 7168, 4864), ("layers", "embed", "ffn"), AXES, False,
     (None, None, "model")),
    ("ep_ffn_overflow", (35, 128, 7168, 4864), ("layers", "experts", "embed", "ffn"),
     AXES_POD, True, (None, "model", "data", "pod")),
    ("batch_multi_axis", (256, 4096), ("batch", None), AXES_POD, False,
     (("pod", "data"), None)),
    ("batch_tiny", (1, 4096), ("batch", None), AXES_POD, False, (None, None)),
    ("kv_seq_sp", (40, 128, 8, 32768, 128), ("layers", "batch", "kv_heads", "kv_seq", None),
     AXES, False, (None, "data", None, "model", None)),
]


@pytest.mark.parametrize("name,shape,axes,mesh,fsdp,want", CASES, ids=[c[0] for c in CASES])
def test_reference_cases(name, shape, axes, mesh, fsdp, want):
    got = shd.spec_for(PDef(shape, axes), mesh, fsdp)
    assert got == want
    assert got == tuple(ref.spec_for(RefPDef(shape, axes), mesh, fsdp))


def test_no_duplicate_mesh_axis_within_tensor():
    s = shd.spec_for(PDef((64, 64), ("heads", "kv_heads")), AXES, False)
    used = [a for a in s if a is not None]
    assert len(used) == len(set(used)) and s == tuple(
        ref.spec_for(RefPDef((64, 64), ("heads", "kv_heads")), AXES, False))


def _stand_in(axes):
    """What the reference's mesh functions read of a ``Mesh``."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(tuple(axes.values()), dtype=object))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_activation_rules_equal_the_reference(mesh):
    m = _stand_in(MESHES[mesh])
    assert shd.batch_axes(m) == ref.batch_axes(m)
    for dim in (1, 2, 3, 8, 16, 24, 32, 128, 256, 512):
        assert shd.batch_dim_spec(dim, m) == ref.batch_dim_spec(dim, m), dim
    for axes in [("batch", None, None), ("batch", None, "model"), ("batch", "model", None, None),
                 (None, "model"), ("pod",), ("data", "nope")]:
        assert shd.act_spec(m, *axes) == tuple(ref.act_spec(m, *axes)), axes
    for n in (1, 8, 14, 16, 32, 40, 56, 64):
        assert shd.heads_shardable(n, m) == ref.heads_shardable(n, m), n
    # the port also takes the sizes themselves and reads them alike
    assert shd.mesh_sizes(MESHES[mesh]) == shd.mesh_sizes(m) == MESHES[mesh]


def test_constrain_spec_is_size_aware():
    m = _stand_in(AXES_POD)
    assert shd.constrain_spec((256, 4096, 1024), m, "batch", None, None) == (
        ("pod", "data"), None, None)
    assert shd.constrain_spec((2, 4096, 151936), m, "batch", None, "model") == (
        "pod", None, "model")
    assert shd.constrain_spec((1, 40, 10), m, "batch", "model", None) == (None, None, None)


def test_param_specs_and_placements_nest_like_the_defs():
    defs = {"a": PDef((16, 32), ("embed", "ffn")), "b": {"c": PDef((8,), ("batch",))}}
    specs = shd.param_specs(defs, AXES, fsdp=True)
    assert specs == {"a": ("data", "model"), "b": {"c": (None,)}}   # 8 rows over 16: none
    assert shd.local_shape((16, 32), specs["a"], AXES) == (1, 2)
    assert shd.local_shape((256, 7), (("pod", "data"), None), AXES_POD) == (8, 7)


def test_replica_meshes_without_a_mesh_and_bad_counts():
    assert shd.replica_meshes(None, 3) == [None, None, None]
    with pytest.raises(ValueError, match="n_replicas"):
        shd.replica_meshes(None, 0)


LOCAL_CODE = r"""
import sys
import torch
from repro_torch.launch import dryrun, mesh as lm
from repro_torch.configs.base import get_config
from repro_torch.models.registry import build_model
from repro_torch.nn.params import flat_defs
from repro_torch.parallel import sharding as shd
from repro_torch.train import steps
dryrun.init_fake_group(512)
bad = 0
for multi in (False, True):
    mesh = lm.make_production_mesh(multi_pod=multi)
    axes = shd.mesh_sizes(mesh)
    for arch in ("arctic_480b", "qwen3_14b"):
        model = build_model(get_config(arch), mesh, device="meta")
        defs = flat_defs(model.defs())
        steps.place_params(model, steps.param_shardings(model, mesh))
        for path, p in model.flat_params().items():
            want = shd.local_shape(defs[path].shape, shd.spec_for(defs[path], axes,
                                                                    model.cfg.fsdp), axes)
            bad += tuple(p.to_local().shape) != want
    subs = shd.replica_meshes(mesh, 4)
    print("replicas", [tuple(s.shape) for s in subs], [s.mesh_dim_names for s in subs])
print("BAD", bad)
"""


def test_param_shardings_local_shapes_equal_the_spec_arithmetic():
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")}
    proc = subprocess.run([sys.executable, "-c", LOCAL_CODE], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD 0" in proc.stdout
    # 256 and 512 ranks split into four disjoint 1-D ("data",) meshes
    assert "replicas [(64,), (64,), (64,), (64,)] [('data',), ('data',), ('data',), ('data',)]" \
        in proc.stdout
    assert "replicas [(128,), (128,), (128,), (128,)]" in proc.stdout
