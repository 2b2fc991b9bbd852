"""The port's spans, device-clock marks and launch counters, in one store.

Tracing is on exactly while a ``torch.profiler`` window is open (the
profiler's own flag, read once per span or mark); there is no other switch.
Off, :func:`span` returns one shared no-op context and :func:`mark` returns.

* :func:`span` -- a named host interval.  On, it opens
  ``torch.profiler.record_function(name)``, so the span lies in the chrome
  trace beside the device's work (the profiler keeps the annotations of the
  thread that opened the window only), and, if the window is still open
  when it closes, appends a :class:`Span` to a bounded record.
  ``timed=True`` reads its two clocks either way.
* :func:`mark` -- a pooled ``torch.cuda.Event`` with timing, recorded on
  the current stream as a group's ``"start"`` or ``"end"``; nothing on the
  CPU, with tracing off, or while the stream captures a graph.
* :func:`record` -- synchronizes and resolves each group's marks into
  device-clock intervals, start to end (work in flight) and end to the next
  start (the gap between two pieces of work), with the spans beside them;
  :func:`reset` clears the record.
* :data:`LAUNCHES` -- kernel launches by name, added to by each kernel
  wrapper where it launches (:func:`count_launch`; also named
  ``kernels.build.LAUNCHES`` and ``kernels.ops.launch_counts``).

The sites: ``train/loop.py`` (``repro.loop.enqueue``, ``repro.loop.sync``,
marks ``loop``), ``data/pipeline.py`` (``repro.loop.prefetch_wait``,
``repro.prefetch.build`` with its child ``repro.prefetch.slot_wait``) and
``kernels/lut_serve.py`` (``repro.serve.run`` with ``repro.serve.stage``
and ``repro.serve.launch``, marks ``serve``); the metrics that read them
are in ``bench/metrics/`` and PERF.md.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# spans and marks kept at most; later ones are dropped
CAP = 1 << 16

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Dict[str, int] = {}
# held across each read-modify-write of LAUNCHES
_COUNT_LOCK = threading.Lock()


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name`` to its counter, atomically."""
    with _COUNT_LOCK:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launches`."""
    return dict(LAUNCHES)


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    thread: str
    start_ns: int               # time.perf_counter_ns()
    end_ns: int


_SPANS: List[Span] = []
_MARKS: List[tuple] = []        # (group, edge, thread, event, device)
_POOL: Dict[torch.device, List[torch.cuda.Event]] = {}
_LOCAL = threading.local()
_OFF = contextlib.nullcontext()


def _stack() -> List[str]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "on", "start_ns", "end_ns", "_parent", "_rf")

    def __init__(self, name: str, on: bool):
        self.name, self.on = name, on

    def __enter__(self) -> "_Span":
        if self.on:
            stack = _stack()
            self._parent = stack[-1] if stack else None
            stack.append(self.name)
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.on:
            self._rf.__exit__(*exc)
            _stack().pop()
            # only spans wholly inside the window: one that outlives it (a
            # worker's, starved while the profiler exports) would misstate it
            if _profiler._is_profiler_enabled and len(_SPANS) < CAP:
                _SPANS.append(Span(self.name, self._parent, threading.current_thread().name,
                                   self.start_ns, self.end_ns))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str, timed: bool = False):
    """A context over a named host interval (module docstring); with
    ``timed`` it is a fresh object whose ``start_ns``, ``end_ns`` and
    ``seconds`` hold the interval once it has closed."""
    on = _profiler._is_profiler_enabled
    if not (on or timed):
        return _OFF
    return _Span(name, on)


def mark(group: str, edge: str, device) -> None:
    """Record a device-clock mark ``edge`` (``"start"`` or ``"end"``) of
    ``group`` on ``device``'s current stream, when tracing is on."""
    if not _profiler._is_profiler_enabled or torch.device(device).type != "cuda":
        return
    if edge not in ("start", "end"):
        raise ValueError(f"a mark's edge is 'start' or 'end', got {edge!r}")
    if torch.cuda.is_current_stream_capturing() or len(_MARKS) >= CAP:
        return
    stream = torch.cuda.current_stream(device)
    pool = _POOL.setdefault(stream.device, [])
    try:
        event = pool.pop()
    except IndexError:
        event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    _MARKS.append((group, edge, threading.get_ident(), event, stream.device))


def record() -> Dict:
    """``{"spans": [Span, ...], "intervals": {group: {"busy_ms": [...],
    "gap_ms": [...]}}}``: the spans in the order they closed, and each
    group's device-clock intervals in milliseconds, paired per thread:
    each start to its end, each end to the next start."""
    marks = list(_MARKS)
    if marks:
        torch.cuda.synchronize()
    intervals: Dict[str, Dict[str, List[float]]] = {}
    last: Dict[tuple, tuple] = {}
    for group, edge, thread, event, _ in marks:
        out = intervals.setdefault(group, {"busy_ms": [], "gap_ms": []})
        prev = last.get((group, thread))
        if prev is not None and prev[0] != edge:
            out["busy_ms" if edge == "end" else "gap_ms"].append(prev[1].elapsed_time(event))
        last[(group, thread)] = (edge, event)
    return {"spans": list(_SPANS), "intervals": intervals}


def reset() -> None:
    """Clear the record; the marks' events go back to the pool."""
    for _, _, _, event, device in _MARKS:
        _POOL.setdefault(device, []).append(event)
    _MARKS.clear()
    _SPANS.clear()
