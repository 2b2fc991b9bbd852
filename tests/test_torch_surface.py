"""The port's public surface covers the reference's.

Every module of the JAX package ``src/repro`` is parsed with ``ast`` (no
import of ``jax``) for its public top-level functions, classes, class
methods and module constants, and each name must have a counterpart of the
same name in the port's module of the same path (``kernels/
lut_serve_pallas.py`` maps to ``kernels/lut_serve_cuda.py``).  The port's
module is imported: a top-level name may be defined there or re-exported,
and a method may come from a base class of the port (``ZooModel.defs``),
never from ``torch.nn.Module`` (whose ``apply`` is another function).

The only exceptions are ``ALLOWED``, one entry per name, each with its
reason; an entry that names nothing in the reference, or a name that the
port now has, fails too, so the list cannot go stale.
"""

import ast
import importlib
import os

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

# reference module -> the port's module, where the path differs
RENAMED = {"kernels/lut_serve_pallas.py": "kernels/lut_serve_cuda.py"}

_ARRAY = "the `jax.Array` type alias; the port annotates with `torch.Tensor`"
_INIT = "a functional `init(key)`; the port's `nn.Module` draws its parameters in `__init__`"
_APPLY = "a functional `apply(params, x)`; the port's `nn.Module` runs `forward`"
_DENSE = "the conv's LUT-Dense view; in the port an `nn.Module` attribute set in `__init__`"

ALLOWED = {
    ("core/hgq_layers.py", "Array"): _ARRAY,
    ("core/hgq_layers.py", "HGQDense.init"): _INIT,
    ("core/hgq_layers.py", "HGQDense.apply"): _APPLY,
    ("core/hgq_layers.py", "HGQConv1D.init"): _INIT,
    ("core/hgq_layers.py", "HGQConv1D.apply"): _APPLY,
    ("core/hgq_layers.py", "HGQConv1D.dense"): _DENSE,
    ("core/lut_layers.py", "Array"): _ARRAY,
    ("core/lut_layers.py", "LUTDense.init"): _INIT,
    ("core/lut_layers.py", "LUTDense.apply"): _APPLY,
    ("core/lut_layers.py", "LUTConv1D.init"): _INIT,
    ("core/lut_layers.py", "LUTConv1D.apply"): _APPLY,
    ("core/lut_layers.py", "LUTConv1D.dense"): _DENSE,
    ("core/lut_layers.py", "LUTConv2D.init"): _INIT,
    ("core/lut_layers.py", "LUTConv2D.apply"): _APPLY,
    ("core/lut_layers.py", "LUTConv2D.dense"): _DENSE,
    ("core/nla_baseline.py", "Array"): _ARRAY,
    ("core/nla_baseline.py", "NLALayer.init"): _INIT,
    ("core/nla_baseline.py", "NLALayer.apply"): _APPLY,
    ("core/quant.py", "Array"): _ARRAY,
    ("kernels/fake_quant.py", "DEF_ROWS"): "Pallas row tile; kernel B1 plans its own grid",
    ("kernels/fake_quant.py", "LANES"): "TPU lane width of the Pallas tile",
    ("kernels/lut_dense.py", "DEF_TB"): "Pallas batch tile; kernel B2's launch_plan sizes its blocks",
    ("kernels/lut_dense.py", "DEF_TCO"): "Pallas C_out tile (one lane register)",
    ("kernels/lut_dense_bwd.py", "LOG2"): "the Pallas kernel's ln 2; `csrc/lut_dense_bwd.cu` has LN2",
    ("kernels/lut_serve_pallas.py", "DEF_BLOCK_BATCH"):
        "Pallas batch block; kernel B4's launch_plan and tile_plan size its tiles",
    ("kernels/lut_serve_pallas.py", "pallas_runner"): "the Pallas runner; the port's is `run_chain`",
    ("kernels/ops.py", "fake_quant_ref"): "re-export of the plain version, in `kernels/ref.py`",
    ("kernels/ops.py", "lut_dense_ref"): "re-export of the plain version, in `kernels/ref.py`",
    ("kernels/ops.py", "lut_dense_train_ref"): "re-export of the plain version, in `kernels/ref.py`",
    ("kernels/ref.py", "Array"): _ARRAY,
    ("launch/serve.py", "serve_tables"): "the tables engine's serving branch, inlined in `main`",
    ("models/lm.py", "Array"): _ARRAY,
    ("models/pid.py", "init_pid_params"): "the port's modules own their parameters (models/pid.py:14)",
    ("models/rwkv.py", "Array"): _ARRAY,
    ("models/whisper.py", "Array"): _ARRAY,
    ("models/zamba.py", "Array"): _ARRAY,
    ("nn/attention.py", "Array"): _ARRAY,
    ("nn/layers.py", "Array"): _ARRAY,
    ("nn/layers.py", "embed_defs"): "called by nothing in the reference",
    ("nn/mlp.py", "Array"): _ARRAY,
    ("nn/moe.py", "Array"): _ARRAY,
    ("nn/params.py", "is_pdef"): "a pytree leaf test for `jax.tree`; the port walks plain dicts",
    ("nn/ssm.py", "Array"): _ARRAY,
    ("optim/compress.py", "Array"): _ARRAY,
}


def _ref_modules():
    out = []
    for root, _dirs, files in os.walk(REF):
        out += [os.path.relpath(os.path.join(root, f), REF).replace(os.sep, "/")
                for f in files if f.endswith(".py")]
    return sorted(out)


MODULES = _ref_modules()


def public_names(source: str) -> set:
    """The public top-level functions, classes, ``Class.method``s and
    module-level names assigned in ``source``."""
    out = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{b.name}" for b in node.body
                       if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and not b.name.startswith("_"))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


def port_module(rel: str):
    mod = RENAMED.get(rel, rel)[:-len(".py")].replace("/", ".")
    if mod == "__init__" or mod.endswith(".__init__"):
        mod = mod[:-len("__init__")].rstrip(".")
    return importlib.import_module("repro_torch" + ("." + mod if mod else ""))


def has_counterpart(module, name: str) -> bool:
    """``name`` (``f`` or ``Class.method``) is defined in or re-exported by
    ``module``; a method counts where a class of the port defines it."""
    if "." not in name:
        return hasattr(module, name)
    cls_name, meth = name.split(".")
    cls = getattr(module, cls_name, None)
    if not isinstance(cls, type):
        return False
    return any(meth in vars(c) for c in cls.__mro__
               if c.__module__.startswith("repro_torch"))


def missing(rel: str, module) -> list:
    with open(os.path.join(REF, rel)) as fh:
        names = public_names(fh.read())
    return sorted(n for n in names
                  if not has_counterpart(module, n) and (rel, n) not in ALLOWED)


@pytest.mark.parametrize("rel", MODULES)
def test_public_surface(rel):
    gaps = missing(rel, port_module(rel))
    assert not gaps, (f"src/repro/{rel}: no counterpart in the port and no entry in "
                      f"ALLOWED for {gaps}")


def test_every_reference_module_has_a_port_module():
    assert len(MODULES) >= 60 and "kernels/lut_serve_pallas.py" in MODULES
    for rel in MODULES:
        path = os.path.join(PORT, RENAMED.get(rel, rel))
        assert os.path.exists(path), f"src/repro/{rel} has no port module"


def test_allowlist_is_honest():
    """Every entry names a public member of its reference module, has no
    counterpart in the port (else it is stale) and gives a reason."""
    for (rel, name), reason in ALLOWED.items():
        with open(os.path.join(REF, rel)) as fh:
            assert name in public_names(fh.read()), f"ALLOWED: src/repro/{rel} has no {name}"
        assert not has_counterpart(port_module(rel), name), (
            f"ALLOWED: the port now has {rel}:{name}; drop the entry")
        assert isinstance(reason, str) and len(reason) > 10, f"ALLOWED: {rel}:{name}"


def test_checker_sees_gaps_and_inheritance():
    """The scan itself: private names are skipped, a missing member is
    reported, a method of a port base class counts, and torch.nn.Module's
    own methods do not."""
    src = ("X = 1\n_y = 2\nArray = int\ndef f(): pass\ndef _g(): pass\n"
           "class C:\n    def m(self): pass\n    def _p(self): pass\n")
    assert public_names(src) == {"X", "Array", "f", "C", "C.m"}
    lm = importlib.import_module("repro_torch.models.lm")
    assert has_counterpart(lm, "DecoderLM.defs") and has_counterpart(lm, "DecoderLM.loss")
    assert not has_counterpart(lm, "DecoderLM.apply")      # nn.Module.apply
    assert not has_counterpart(lm, "DecoderLM.no_such_method")
    assert not has_counterpart(lm, "no_such_function")
