"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and importing
the port builds nothing and needs no GPU."""

import ast
import importlib
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


FILES = _port_files()


def _modules():
    mods = []
    for path in FILES:
        rel = os.path.relpath(path, os.path.join(REPO, "src"))
        if rel.startswith(".."):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _foreign(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    bad = sorted({n for n in _imported(tree) if _foreign(n)})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {os.path.relpath(p, REPO) for p in FILES}
    assert "chip_smoke.py" in names
    assert os.path.join("src", "repro_torch", "kernels", "lut_serve_cuda.py") in names
    assert _foreign("repro.core.dais") and _foreign("jax.numpy")
    assert not _foreign("repro_torch.core.dais")


@pytest.mark.parametrize("mod", _modules())
def test_import_builds_nothing(mod):
    from repro_torch.kernels import build

    before = dict(build._LOADED)
    importlib.import_module(mod)
    assert build._LOADED == before, "importing the port loaded a kernel library"


def test_fresh_import_touches_no_device():
    """In a fresh interpreter, importing every port module loads no kernel
    library and does not initialise CUDA."""
    code = ("import importlib, torch\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "from repro_torch.kernels import build\n"
            "assert build._LOADED == {}, build._LOADED\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
