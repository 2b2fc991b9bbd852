"""``bench/run.py`` as a check of the benchmark starts it: with no card it
exits non-zero with a message and prints no result, and so it does in a
directory that holds only BENCHMARK.json and the benchmark's files.  On a card (tests
marked ``cuda``) one short run of each cell prints a correct result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
ARGS = ["--seed", str(2 ** 32 + 5), "--seconds", "2", "--trace", "0"]


def _run(cwd, workload, args=ARGS, timeout=600):
    return subprocess.run([sys.executable, *SPEC["command"][1:], "--workload", workload,
                           *args], cwd=cwd, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_no_card_exits_nonzero_without_result(no_card):
    r = _run(ROOT, SPEC["workloads"][0]["name"])
    assert r.returncode != 0
    assert "CUDA card" in r.stderr and r.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in SPEC["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path, SPEC["workloads"][0]["name"])
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    r = _run(ROOT, workload, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
