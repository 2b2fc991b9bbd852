"""Reading a ``torch.profiler`` window of the card.

:func:`profile` runs ``fn`` inside a profiler window marked by a user
annotation, exports the trace to a temporary file, and reduces it to what
the per-layer metrics read: the device's busy seconds (the union of its
kernels, copies and fills inside the window), the window's seconds, time
and event count by device operation, the top device operations and the
idle gaps named by what the host was doing.  Profiles have been seen to
drop kernel events at random and to record a CUDA graph's copy nodes as
``memcpy32_post`` kernels, so readers take times per recorded event and
counts from the program's launch counters, never event counts.
"""

from __future__ import annotations

import heapq
import json
import os
import shutil
import tempfile
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
TOP = 10


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_trace(events: List[Dict]) -> Dict:
    """The window's numbers from chrome-trace events (times in us)."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW and "dur" in e]
    if not marks:
        raise RuntimeError("the profiler trace holds no window annotation")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    dev, ops = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        t, n = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (t + (b - a) * 1e-6, n + 1)
    busy = _union(dev)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") in HOST_CATS and "dur" in e
                   and e.get("name") != WINDOW), key=lambda t: t[0])
    idle: Dict[str, float] = {}
    # a sweep over the gaps in time order: the host events open at a gap's
    # midpoint, the one that opened last (the innermost) names the gap
    by_start: List[Tuple[float, int]] = []
    nxt = 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt][0] <= mid:
            heapq.heappush(by_start, (-host[nxt][0], nxt))
            nxt += 1
        while by_start and host[by_start[0][1]][1] < mid:
            heapq.heappop(by_start)
        name = host[by_start[0][1]][2] if by_start else "host outside any op"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "ops": {k: {"seconds": t, "events": n} for k, (t, n) in ops.items()},
            "breakdown": {
                "device_ops": [[k, v[0]] for k, v in
                               sorted(ops.items(), key=lambda kv: -kv[1][0])[:TOP]],
                "idle_gaps": [[k, v] for k, v in
                              sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}}


def profile(fn: Callable[[], object]) -> Tuple[object, Dict]:
    """``(fn(), trace numbers)``: ``fn`` runs inside the profiler window,
    the device synchronised at both ends.  The trace file lives in a
    temporary directory under ``TMPDIR`` and is removed."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, reduce_trace(events)


def kernel_time(ops: Dict, marks) -> Tuple[float, int]:
    """Seconds and recorded events of the device operations whose names
    hold any of ``marks``."""
    t, n = 0.0, 0
    for name, v in ops.items():
        if any(m in name for m in marks):
            t += v["seconds"]
            n += v["events"]
    return t, n
