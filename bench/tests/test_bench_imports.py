"""Nothing the benchmark runs loads the JAX stack or reads the JAX
package's benchmarks, and its references load nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _strings(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_stack_and_no_benchmarks_folder(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = {name.split(".", 1)[0] for name in _imports(tree)}
    assert not tops & FORBIDDEN, f"{path.name} imports {tops & FORBIDDEN}"
    if path.name != "test_bench_imports.py":
        assert not any("benchmarks/" in s or s == "benchmarks" for s in _strings(tree))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_load_nothing_of_the_program(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = {name.split(".", 1)[0] for name in _imports(tree)}
    assert tops <= {"__future__", "math", "typing", "torch", "numpy"}, tops


def test_the_check_catches_a_jax_import(tmp_path):
    bad = "import numpy\nfrom jax import numpy as jnp\nimport repro.core\nimport repro_torch\n"
    tops = {n.split(".", 1)[0] for n in _imports(ast.parse(bad))}
    assert tops & FORBIDDEN == {"jax", "repro"}
