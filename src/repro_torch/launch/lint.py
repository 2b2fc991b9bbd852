"""Static IR lint: every ``core/analysis.py`` pass over a program, reported.

Runs the three static passes on a DAIS program — the structural verifier,
the interval range analysis, and (optionally) a self-certified DCE round
discharged by ``validate_rewrite`` — and prints a per-register range/width
report plus the program-level width story:

* ``required_width`` — the conservative structural bound of
  ``DaisProgram.required_width()`` (what dtype selection used before the
  analyzer existed),
* ``proven_width``   — the sound per-register interval bound, including
  transients (always ``<= required_width``),
* ``engine_width``   — proven values plus the structural constants a
  backend materializes; this is what ``compile_program`` sizes its dtype
  from,
* live table entries — the fraction of composed-stage table entries the
  proven ranges can actually reach, i.e. what the chain packer's
  range-driven lane narrowing acts on.

Sources: ``--model`` builds the same untrained model specs as
``launch/serve.py``, its layers, table extraction and lowering on
``--device`` (``cuda`` unless told ``--device cpu``); the passes themselves
are numpy over the lowered program.  Positional paths are compiled-artifact
bundles (``serve/artifact.py``, either package's), hash-checked and
structurally verified on load; a bundle that fails is reported REJECTED.
Exit status is non-zero when any bundle is rejected or any program fails
the verifier, making this the CI ``ir-verify`` gate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.lint jsc.npz pid.npz
    PYTHONPATH=src python -m repro_torch.launch.lint --model lut-stack \
        --lut-dims 16,20,5
    PYTHONPATH=src python -m repro_torch.launch.lint --model pid-hybrid --ctx 100 \
        --all-regs
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import torch

from repro_torch.core.analysis import (AnalysisError, analyze_ranges,
                                 verify_program)
from repro_torch.core.dais import DaisProgram


def _fmt_reg(prog: DaisProgram, r: int, ranges) -> str:
    ins = prog.instrs[r]
    reg = ins.reg
    lo, hi = ranges.range(r)
    s = "s" if reg.signed else "u"
    extra = ""
    if ranges.transient_width(r) > ranges.width(r):
        tlo, thi = ranges.transient_lo[r], ranges.transient_hi[r]
        extra = f"  transient=[{tlo}, {thi}] w={ranges.transient_width(r)}"
    return (f"  r{r:<5d} {ins.op:<7s} f={reg.f:<3d} "
            f"decl={reg.width}{s:<2s} range=[{lo}, {hi}] "
            f"w={ranges.width(r)}{extra}")


def live_table_stats(prog: DaisProgram, ranges) -> Optional[dict]:
    """Live/total composed-table entries under the proven ranges.

    ``None`` when the program does not fuse (no composed tables to
    narrow).  This is the quantity the chain packer's lane narrowing
    consumes; ``launch/pareto.py`` records it per frontier point.
    """
    from repro_torch.kernels.lut_serve import compose_fused_stages

    stages, _reason = compose_fused_stages(prog, ranges=ranges)
    if stages is None:
        return None
    total = live = 0
    for st in stages.stages:
        if st.table is None:
            continue
        total += int(st.table.size)
        live += int(st.live.sum()) if st.live is not None \
            else int(st.table.size)
    if total == 0:
        return None
    return {"table_entries": total, "live_entries": live}


def lint_program(prog: DaisProgram, *, name: str = "program",
                 dce: bool = True, all_regs: bool = False,
                 max_regs: int = 24,
                 echo: Callable[[str], None] = print) -> dict:
    """Run every static pass over ``prog``; print and return the report.

    The returned dict always carries ``ok`` plus ``n_diagnostics``; when
    the verifier passes it adds ``required_width`` / ``proven_width`` /
    ``engine_width``, the live-table stats, and (``dce=True``) whether the
    self-certified DCE round's obligations were discharged.
    """
    echo(f"[lint] {name}: {prog.n_instrs()} instrs, "
         f"{len(prog.input_f)} inputs, {len(prog.outputs)} outputs")
    diags = verify_program(prog, raise_on_error=False)
    for d in diags:
        echo(f"[lint]   VERIFY {d}")
    if diags:
        echo(f"[lint] {name}: FAILED the structural verifier "
             f"({len(diags)} diagnostics)")
        return {"ok": False, "n_diagnostics": len(diags)}
    echo("[lint]   verifier: ok")

    t0 = time.time()
    try:
        ranges = analyze_ranges(prog)
    except AnalysisError as e:
        # raised only when the soundness invariant proven <= required is
        # itself violated — an analyzer bug, which must never hide
        echo(f"[lint]   ANALYSIS {e}")
        return {"ok": False, "n_diagnostics": 1}
    required = prog.required_width()
    report = {
        "ok": True, "n_diagnostics": 0,
        "required_width": required,
        "proven_width": ranges.proven_width(),
        "engine_width": ranges.engine_width(),
    }
    echo(f"[lint]   ranges: required_width={required} "
         f"proven_width={report['proven_width']} "
         f"engine_width={report['engine_width']} "
         f"({time.time() - t0:.2f}s)")

    regs = list(range(prog.n_instrs())) if all_regs else \
        [r for r in range(prog.n_instrs())
         if prog.instrs[r].op == "IN"] + list(prog.outputs)
    label = "all registers" if all_regs else "inputs + outputs"
    echo(f"[lint]   per-register ranges ({label}):")
    shown = regs if all_regs else regs[:max_regs]
    for r in shown:
        echo(_fmt_reg(prog, r, ranges))
    if len(regs) > len(shown):
        echo(f"  ... and {len(regs) - len(shown)} more "
             f"(--all-regs for every register)")

    stats = live_table_stats(prog, ranges)
    if stats is not None:
        report.update(stats)
        pct = 100.0 * stats["live_entries"] / stats["table_entries"]
        echo(f"[lint]   composed tables: {stats['live_entries']}/"
             f"{stats['table_entries']} entries live ({pct:.1f}%)")

    if dce:
        from repro_torch.core.opt import eliminate_dead_cells
        t0 = time.time()
        _opt, rep = eliminate_dead_cells(prog)   # validates its own rewrite
        report["dce_validated"] = True
        echo(f"[lint]   dce round self-certified "
             f"(validate_rewrite ok, {time.time() - t0:.2f}s): "
             f"{rep.summary()}")
    return report


def lint_bundle(path: str, *, dce: bool = True, all_regs: bool = False,
                echo: Callable[[str], None] = print) -> dict:
    """Load (hash-check + structurally verify) a bundle, then lint it."""
    from repro_torch.serve.artifact import ArtifactError, load_artifact

    try:
        art = load_artifact(path)
    except ArtifactError as e:
        echo(f"[lint] {path}: REJECTED\n{e}")
        return {"ok": False, "n_diagnostics": 1}
    echo(f"[lint] {path}: bundle ok (hash {art.content_hash[:12]}, "
         f"format v{art.meta.get('format_version')})")
    return lint_program(art.prog, name=path, dce=dce, all_regs=all_regs,
                        echo=echo)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="static DAIS IR lint: verifier + range analysis + "
                    "self-certified DCE")
    ap.add_argument("bundles", nargs="*",
                    help="compiled-artifact bundle paths (.npz)")
    ap.add_argument("--model", choices=("lut-stack", "pid-hybrid"),
                    default=None,
                    help="lint a freshly built (untrained) model program "
                         "instead of (or in addition to) bundles")
    ap.add_argument("--lut-dims", default="16,20,5")
    ap.add_argument("--lut-hidden", type=int, default=8)
    ap.add_argument("--in-f", type=int, default=4)
    ap.add_argument("--in-i", type=int, default=2)
    ap.add_argument("--ctx", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device the model's layers, table extraction and "
                         "lowering run on")
    ap.add_argument("--all-regs", action="store_true",
                    help="print every register's range, not just "
                         "inputs + outputs")
    ap.add_argument("--no-dce", action="store_true",
                    help="skip the self-certified DCE round")
    args = ap.parse_args(argv)
    if not args.bundles and args.model is None:
        ap.error("nothing to lint: pass bundle paths and/or --model")

    ok = True
    for path in args.bundles:
        rep = lint_bundle(path, dce=not args.no_dce, all_regs=args.all_regs)
        ok = ok and rep["ok"]
    if args.model is not None:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("--device cuda but no CUDA device is available")
        from repro_torch.launch.serve import build_model_program
        prog, desc = build_model_program(args, device)
        rep = lint_program(prog, name=desc, dce=not args.no_dce,
                           all_regs=args.all_regs)
        ok = ok and rep["ok"]
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
