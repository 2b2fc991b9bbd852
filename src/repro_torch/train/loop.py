"""Chunked training loop: K optimizer steps per call (port of ``repro.train.loop``).

The per-step loop pays the host's cost of every step: a JSC-HLF step at
B = 16600 enqueues about a thousand small device kernels, and the host takes
longer to enqueue them than the card takes to run them.  This loop runs K
steps per call:

* **one launch per chunk** -- :func:`make_chunked_step` runs the K steps of
  a chunk either as a plain loop (``mode="eager"``) or as one
  ``torch.cuda.CUDAGraph`` captured over the K steps and replayed
  (``mode="graph"``), the counterpart of the reference's one jitted
  ``lax.scan``.  A graph is captured once per distinct k, as the reference
  compiles once per distinct k;
* **on-device metrics** -- every step's metrics are stacked on the device and
  cross to the host once per chunk, as one ``(n_metrics, k)`` transfer;
* **async host prefetch** -- batch synthesis, pinned staging and the copy to
  the card for chunk N+1 run on a worker thread (``data/pipeline.py``) while
  chunk N computes;
* **boundary-exact planning** -- :func:`plan_chunks` never lets a chunk cross
  a checkpoint / crash / snapshot boundary.

Under a ``torch.profiler`` window (``repro_torch/tracing.py``) each chunk
opens the spans ``repro.loop.enqueue`` (the chunk's call, the interval of
``ChunkResult.host_s``) and ``repro.loop.sync`` (the metrics transfer, which
waits for the chunk), and marks the device clock ``loop`` ``start`` just
before the call and ``end`` just after it returns: start to end is the
chunk on the device, end to the next start the gap between two chunks.

The port's step is stateful: ``step_fn(opt_state, batch) -> (opt_state,
metrics)`` from ``train/steps.py::make_lut_train_step`` writes the layers'
parameters and batch-norm stats in place.  :func:`chunked_train` and
:func:`run_chunked` keep the reference's argument order; their ``params`` is
the dict of tensors the step trains in place (``named_params(layers)``),
passed through untouched.

Bit-exactness: grouping steps into chunks, eager or graph, changes no bit of
the parameters, the Adam state or the BN stats: the chunk runs the same
kernels on the same inputs in the same order as the per-step loop
(``tests/test_torch_train_loop.py`` on the CPU, ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.data.pipeline import chunk_stream

MODES = ("eager", "graph")


def plan_chunks(start: int, stop: int, chunk_steps: int,
                boundaries: Iterable[int] = ()) -> List[Tuple[int, int]]:
    """Split steps ``[start, stop)`` into ``(first_step, k)`` segments.

    Each segment runs ``k <= chunk_steps`` consecutive steps and never
    crosses a boundary step, so host-visible side effects pinned to
    boundaries (checkpoint saves, simulated crashes, β-sweep snapshots)
    land at exactly the same step indices as a per-step loop.  Resuming
    from an arbitrary ``start`` is safe: chunk grouping does not affect the
    math, only the launch count.
    """
    if chunk_steps < 1:
        raise ValueError(f"chunk_steps must be >= 1, got {chunk_steps}")
    if stop < start:
        raise ValueError(f"empty step range [{start}, {stop})")
    cuts = sorted({b for b in boundaries if start < b < stop})
    segments: List[Tuple[int, int]] = []
    step = start
    while step < stop:
        next_cut = next((b for b in cuts if b > step), stop)
        k = min(chunk_steps, next_cut - step)
        segments.append((step, k))
        step += k
    return segments


def _chunk_len(batches: Dict[str, torch.Tensor]) -> int:
    return int(next(iter(batches.values())).shape[0])


def _row(batches: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {key: b[i] for key, b in batches.items()}


def _stack_metrics(rows: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {name: torch.stack([r[name] for r in rows]) for name in rows[0]}


def _copy_state(dst, src) -> None:
    """Copy the tensors of the Adam state ``src`` into ``dst`` (same keys)."""
    if isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise KeyError(f"optimizer state keys {sorted(src)} != {sorted(dst)}")
        for key in dst:
            _copy_state(dst[key], src[key])
    else:
        dst.copy_(src)


def _eager_chunk(step_fn: Callable) -> Callable:
    def chunk_fn(opt_state, batches):
        rows = []
        for i in range(_chunk_len(batches)):
            opt_state, metrics = step_fn(opt_state, _row(batches, i))
            rows.append(metrics)
        return opt_state, _stack_metrics(rows)

    return chunk_fn


@dataclasses.dataclass
class _Captured:
    graph: Any                          # torch.cuda.CUDAGraph over k steps
    batches: Dict[str, torch.Tensor]    # the (k, ...) inputs every replay reads
    metrics: Dict[str, torch.Tensor]    # the (k,) metrics every replay writes
    launches: Dict[str, int]            # kernel launches one replay makes


class _GraphChunk:
    """K steps captured once per distinct k into a CUDA graph, then replayed.

    Every graph reads and writes one Adam state at fixed addresses: the
    dict the first call passes in (a later call with another dict is copied
    into it), which each captured chunk ends by overwriting with the state
    after its last step.  Parameters and BN stats are written in place by
    the step itself.  Each graph reads its batch from a static ``(k, ...)``
    buffer on the card, filled by a copy on the current stream before each
    replay, so a replay never reads a buffer the prefetcher is filling.

    Before a capture, the step runs once with ``commit=False`` on the capture
    stream: that builds the kernels, runs their occupancy queries and plans,
    sizes B3's scratch and lets PyTorch make its per-stream state, none of
    which a capture may contain, and writes nothing back.  The capture runs
    in ``thread_local`` mode: the prefetcher's worker keeps allocating
    pinned and device memory and copying on its own stream meanwhile.

    The kernel wrappers count their launches at capture time, when nothing
    runs on the device; the chunk takes those counts back and adds them to
    ``tracing.LAUNCHES`` on every replay instead.
    """

    def __init__(self, step_fn: Callable, device: torch.device):
        self.step_fn = step_fn
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.opt_state = None
        self.captured: Dict[int, _Captured] = {}

    def __call__(self, opt_state, batches):
        if self.opt_state is None:
            self.opt_state = opt_state
        elif opt_state is not self.opt_state:
            _copy_state(self.opt_state, opt_state)
        k = _chunk_len(batches)
        cap = self.captured.get(k)
        if cap is None:
            cap = self.captured[k] = self._capture(k, batches)
        else:
            for key, b in batches.items():
                cap.batches[key].copy_(b)
        cap.graph.replay()
        for name, n in cap.launches.items():
            tracing.count_launch(name, n)
        return self.opt_state, cap.metrics

    def _capture(self, k: int, batches) -> _Captured:
        static = {key: b.clone() for key, b in batches.items()}
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.step_fn(self.opt_state, _row(static, 0), commit=False)
        current.wait_stream(self.stream)
        before = dict(tracing.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
            opt_state, rows = self.opt_state, []
            for i in range(k):
                opt_state, metrics = self.step_fn(opt_state, _row(static, i))
                rows.append(metrics)
            _copy_state(self.opt_state, opt_state)
            stacked = _stack_metrics(rows)
        launches = {name: tracing.LAUNCHES[name] - before[name] for name in before}
        tracing.LAUNCHES.update(before)
        return _Captured(graph, static, stacked, launches)


def _resolve_mode(mode: Optional[str], device: torch.device) -> str:
    """``mode`` or the device's default: graph on a CUDA device, eager on
    the CPU.  Graph mode anywhere but on a CUDA device raises."""
    if mode is None:
        mode = "graph" if device.type == "cuda" else "eager"
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "graph" and device.type != "cuda":
        raise ValueError(f"graph mode captures CUDA graphs and needs a CUDA device, "
                         f"got {device}")
    return mode


def make_chunked_step(step_fn: Callable, mode: Optional[str] = None,
                      device=None) -> Callable:
    """``chunk_fn(opt_state, batches) -> (opt_state, metrics)`` over ``step_fn``.

    ``step_fn(opt_state, batch)`` is the stateful step of
    ``make_lut_train_step``; graph mode also calls it once with
    ``commit=False`` before each capture, which must run the whole step and
    write nothing back.  ``batches`` is a dict of tensors on ``device``
    (default the card) with a leading chunk axis of length k; the metrics come
    back as a dict of ``(k,)`` tensors on the device (each step's metrics
    0-d tensors of one dtype).  ``mode`` is ``"eager"`` (a Python loop over
    the k steps) or ``"graph"`` (one CUDA graph per distinct k, captured on
    the first chunk of that length and replayed); ``None`` takes graph on a
    CUDA device and eager on the CPU.  In graph mode the returned state and
    metrics are the graph's own tensors, which the next call overwrites.
    """
    device = torch.device("cuda" if device is None else device)
    if _resolve_mode(mode, device) == "eager":
        return _eager_chunk(step_fn)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _GraphChunk(step_fn, device)


@dataclasses.dataclass
class ChunkResult:
    """One executed chunk: the state after it and its host-side metrics.

    ``params`` is the dict the loop was given (the tensors the step trains
    in place, e.g. ``named_params(layers)``), holding the values after the
    chunk; ``opt_state`` is the Adam state after it.  In graph mode both are
    overwritten by the next chunk: hold only the latest result's state.
    """

    step: int                       # first step index in the chunk
    k: int                          # steps executed ([step, step + k))
    params: Any
    opt_state: Any
    metrics: Dict[str, np.ndarray]  # each metric stacked to shape (k,)
    dt_s: float                     # wall time, dispatch → host-visible
    compiled: bool                  # first use of this k: capture-inclusive
    host_s: float = 0.0             # wall time to enqueue the chunk


def chunked_train(step_fn: Callable, params, opt_state,
                  get_batch: Callable[[int], dict], start: int, stop: int, *,
                  chunk_steps: int = 8, boundaries: Iterable[int] = (),
                  prefetch: bool = True, prefetch_depth: int = 2,
                  mode: Optional[str] = None) -> Iterator[ChunkResult]:
    """Drive ``step_fn`` over steps ``[start, stop)`` in chunks.

    Yields a :class:`ChunkResult` after each chunk *completes on the device*
    (the metrics transfer waits for it, so ``dt_s`` measures real compute
    boundaries, not the enqueue; ``host_s`` is the enqueue alone).
    ``get_batch(step)`` returns one step's batch as a dict of numpy arrays
    and runs on the prefetch thread when ``prefetch=True``; chunks are
    staged on the device of ``params``, the dict of tensors the step trains
    in place.  ``mode`` as in :func:`make_chunked_step`.
    """
    device = next(iter(params.values())).device
    chunk_fn = make_chunked_step(step_fn, mode=mode, device=device)
    segments = plan_chunks(start, stop, chunk_steps, boundaries)
    seen_lengths: set = set()
    for step, k, batches in chunk_stream(get_batch, segments, prefetch=prefetch,
                                         depth=prefetch_depth, device=device):
        compiled = k not in seen_lengths
        seen_lengths.add(k)
        tracing.mark("loop", "start", device)
        with tracing.span("repro.loop.enqueue", timed=True) as enqueue:
            opt_state, metrics = chunk_fn(opt_state, batches)
        tracing.mark("loop", "end", device)
        # ONE device→host transfer per chunk; it waits for the chunk to end,
        # which is what makes dt_s a real boundary
        with tracing.span("repro.loop.sync"):
            values = torch.stack(list(metrics.values())).cpu().numpy()
        dt_s = (time.perf_counter_ns() - enqueue.start_ns) * 1e-9
        yield ChunkResult(step, k, params, opt_state, dict(zip(metrics, values)),
                          dt_s, compiled, enqueue.seconds)


def run_chunked(step_fn: Callable, params, opt_state,
                get_batch: Callable[[int], dict], start: int, stop: int,
                on_chunk: Callable[[ChunkResult], None] = None,
                **kwargs) -> Tuple[Any, Any, Dict[str, np.ndarray]]:
    """Convenience wrapper over :func:`chunked_train`.

    Returns ``(params, opt_state, last_metrics)`` after the final chunk;
    ``on_chunk`` (if given) fires once per completed chunk.
    """
    metrics: Dict[str, np.ndarray] = {}
    for res in chunked_train(step_fn, params, opt_state, get_batch,
                             start, stop, **kwargs):
        params, opt_state, metrics = res.params, res.opt_state, res.metrics
        if on_chunk is not None:
            on_chunk(res)
    return params, opt_state, metrics
