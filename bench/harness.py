"""What every run shares: the cell from ``BENCHMARK.json`` and the files it
names, the metrics it reports, the check that no JAX module was loaded,
and the result's lines.

Everything of one configuration, traffic mix, cell or metric sits in a file
of its own, found by its name:

* ``BENCHMARK.json``'s ``configs[].file``: the configuration (its
  ``family`` names ``bench/families/<family>.py``); its plain reference is
  ``bench/reference/<config>.py``;
* ``bench/traffic/<traffic>.json``: the mix's parameters (its ``kind``
  names the module ``bench/kinds/<kind>.py`` that runs it);
* ``bench/cells/<workload>.json``: the limits of the cell's compared
  numbers, with the readings they were set from;
* ``bench/metrics/<metric>.py``: the reader of one metric, ``read(run)``,
  which returns a number or None (nothing to read).  A dotted name
  ``<base>.<part>`` with no file of its own is the base's quantity split by
  the end-to-end metric it moves (``idle_pct.score``, ``b1_roofline.sweep``)
  and is read by ``bench/metrics/<base>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
# the JAX package and its stack, by top-level module name; the port is
# ``repro_torch``, which is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: Dict, workload: str, root: Path) -> Dict:
    """The cell ``workload`` with its configuration, traffic and limits."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return {"workload": workload, "config": w["config"], "traffic": w["traffic"],
            "chips": w["chips"],
            "config_data": json.loads((root / cfg["file"]).read_text()),
            "traffic_data": json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
            "limits": json.loads((BENCH / "cells" / f"{workload}.json").read_text())["limits"]}


def metrics_for(spec: Dict, workload: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones:
    those listing the cell, and those listing no cells where the cell
    reports the end-to-end metric they move."""
    def listed(m: Dict) -> Optional[bool]:
        return workload in m["workloads"] if "workloads" in m else None

    e2e = [m for m in spec["end_to_end"] if listed(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if listed(m) or (listed(m) is None and m["moves"] in names)]


def reader_path(name: str) -> Path:
    """``bench/metrics/<name>.py``, or that of the longest dotted prefix of
    ``name`` that has a file."""
    base = name
    while not (BENCH / "metrics" / f"{base}.py").is_file() and "." in base:
        base = base.rsplit(".", 1)[0]
    return BENCH / "metrics" / f"{base}.py"


def reader(name: str):
    """The module that reads metric ``name`` (:func:`reader_path`)."""
    path = reader_path(name)
    mod_name = "bench_metric_" + path.stem.replace(".", "_")
    module = sys.modules.get(mod_name)
    if module is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[mod_name] = module
    return module


def read_metrics(entries: List[Dict], run: Dict) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        v = reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def family(cfg: Dict):
    """The module of ``bench/families/<family>.py`` of a configuration."""
    return importlib.import_module(f"bench.families.{cfg['family']}")


def kind(cell: Dict):
    return importlib.import_module(f"bench.kinds.{cell['traffic_data']['kind']}")


def judge(numbers: Dict[str, Dict], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each compared number beside its limit, and whether it holds."""
    out = {}
    for name, limit in limits.items():
        v = numbers[name]["value"]
        out[name] = {"value": v, "limit": limit,
                     "ok": bool(math.isfinite(v) and v <= limit)}
    return out


def emit(result: Dict, compared: Dict[str, Dict]) -> None:
    """Stderr's last lines, each compared number beside its limit; then the
    result's line, last on stdout, with the compared numbers last in it."""
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}"
              f"{'' if c['ok'] else ' FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    num = lambda v: v if math.isfinite(v) else repr(v)
    line["compared"] = {k: {"value": num(c["value"]), "limit": c["limit"]}
                        for k, c in compared.items()}
    print(json.dumps(line), flush=True)
