"""BENCHMARK.json against the benchmark's rules, and every name in it
resolved to its files."""

import json
import math
import re
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
E2E = [m["name"] for m in SPEC["end_to_end"]]
LAYER = [m["name"] for m in SPEC["per_layer"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"]), word
            assert (ROOT / word).is_file()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CONFIGS)
def test_config_resolves(name):
    c = {c["name"]: c for c in SPEC["configs"]}[name]
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(name) and _line(c["source"]) and _line(c["why"])
    assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    data = json.loads((ROOT / c["file"]).read_text())
    assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
    assert all(NAME.match(k) for k in c["reduced"])
    assert (BENCH / "families" / f"{data['family']}.py").is_file()
    assert (BENCH / "reference" / f"{name}.py").is_file()
    assert any(w["config"] == name for w in SPEC["workloads"])
    files = [x["file"] for x in SPEC["configs"]]
    assert files.count(c["file"]) == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = {w["name"]: w for w in SPEC["workloads"]}[name]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(name) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] in (1, 4) and w["config"] in CONFIGS
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert (BENCH / "kinds" / f"{traffic['kind']}.py").is_file()
    limits = json.loads((BENCH / "cells" / f"{name}.json").read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    pairs = [(x["config"], x["traffic"]) for x in SPEC["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1
    e2e = [m for m in SPEC["end_to_end"] if _reports(m, name)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    names = {m["name"] for m in e2e}
    layer = [m for m in SPEC["per_layer"] if ("workloads" in m and name in m["workloads"])
             or ("workloads" not in m and m["moves"] in names)]
    assert layer


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("name", E2E)
def test_end_to_end_metric(name):
    m = {m["name"]: m for m in SPEC["end_to_end"]}[name]
    assert set(m) - {"workloads"} == E2E_KEYS
    assert NAME.match(name) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25 and math.isfinite(m["bound"])
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert harness.reader_path(name).is_file()


@pytest.mark.parametrize("name", LAYER)
def test_per_layer_metric(name):
    m = {m["name"]: m for m in SPEC["per_layer"]}[name]
    assert set(m) - {"workloads"} == LAYER_KEYS
    assert NAME.match(name) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _line(m["layer"]) and m["moves"] in E2E
    moves = {x["name"]: x for x in SPEC["end_to_end"]}[m["moves"]]
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS and _reports(moves, cell), (name, cell)
    if name.endswith("_roofline") or "mfu" in name:
        assert m["unit"] == "%"
    assert harness.reader_path(name).is_file()


def test_names_are_unique_and_layers_consistent():
    for group in (CELLS, CONFIGS, E2E + LAYER):
        assert len(group) == len(set(group))
    assert "setup_s" in E2E
    assert {m["name"]: m for m in SPEC["end_to_end"]}["setup_s"]["bound"] <= 0.25


def test_bench_files_are_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
