"""Async host→device input pipeline (port of ``repro.data.pipeline``).

The chunked training loop (``train/loop.py``) consumes *chunks*: K
per-step batches stacked along a new leading axis, one copy to the device and
one call per chunk.  This module builds those chunks, either synchronously or
on a background prefetch thread:

* :func:`stack_batches` -- build K host batches and stack their arrays;
* :class:`HostPrefetcher` -- a worker thread that runs ``get_batch``, stacks
  the chunk into pinned host memory and copies it to the card with
  ``non_blocking=True`` on a stream of its own, while the card still runs the
  chunk before; the consumer's stream waits on the copy's event before it
  reads the chunk, and a pinned buffer is not rewritten until its last copy
  has finished;
* :func:`chunk_stream` -- one generator over both modes.

A batch is a dict of numpy arrays; a chunk is the same dict of tensors on the
device, each with the leading axis of length k.

Under a ``torch.profiler`` window (``repro_torch/tracing.py``) building a
chunk opens the span ``repro.prefetch.build`` (on the worker thread, or in
the consumer's on the synchronous path), with the child
``repro.prefetch.slot_wait`` while the worker waits for a pinned buffer's
last copy to end; the consumer's wait for the next chunk opens
``repro.loop.prefetch_wait``.

Determinism contract: ``get_batch(step)`` must be a pure function of the step
index (plus whatever seed it closes over); the pipeline only changes *where
and when* batches are built, never *which* batches.  The prefetcher calls
``get_batch`` strictly in step order on a single worker thread, so even a
stateful host RNG drawn once per step sees the exact sequence the synchronous
loop would, and the same segments always produce bit-identical chunks
(``tests/test_torch_train_loop.py``).

Shutdown contract: :meth:`HostPrefetcher.close` (or leaving the context
manager / abandoning :func:`chunk_stream`) always stops and joins the worker
and drops queued chunks: no leaked thread, no stranded chunk, including when
``get_batch`` raises (the exception is re-raised in the consumer).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing


def _stack(batches: List[dict], out: Optional[Dict[str, np.ndarray]] = None) -> dict:
    return {key: np.stack([np.asarray(b[key]) for b in batches],
                          out=None if out is None else out[key])
            for key in batches[0]}


def stack_batches(get_batch: Callable[[int], dict], step: int, k: int) -> dict:
    """K consecutive host batches stacked into one chunk: every array gains a
    leading axis of length ``k``, the axis the chunked step walks."""
    if k < 1:
        raise ValueError(f"chunk length must be >= 1, got {k}")
    return _stack([get_batch(step + i) for i in range(k)])


def _default_device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _PinnedSlot:
    """Pinned host buffers for one chunk, and the event of their last copy."""

    def __init__(self):
        self.buffers: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def fill(self, batches: List[dict]) -> Dict[str, torch.Tensor]:
        """Stack ``batches`` into the buffers, after their last copy ended."""
        if self.copied is not None:
            with tracing.span("repro.prefetch.slot_wait"):
                self.copied.synchronize()
        first = {key: np.asarray(v) for key, v in batches[0].items()}
        want = {key: ((len(batches),) + a.shape, torch.from_numpy(np.empty(0, a.dtype)).dtype)
                for key, a in first.items()}
        if {key: (tuple(b.shape), b.dtype) for key, b in self.buffers.items()} != want:
            self.buffers = {key: torch.empty(shape, dtype=dtype, pin_memory=True)
                            for key, (shape, dtype) in want.items()}
        _stack(batches, out={key: b.numpy() for key, b in self.buffers.items()})
        return self.buffers


class HostPrefetcher:
    """Builds chunks on a background thread.

    ``segments`` is the chunk plan, ``(first_step, k)`` pairs, typically from
    ``train/loop.plan_chunks``.  ``depth`` bounds how many finished chunks may
    wait on the device ahead of the consumer (2: one in flight, one ready).
    ``device`` is where the chunks go, the card by default; on the CPU the
    stacked arrays are handed over as they are.
    """

    _DONE = ("done", None)

    def __init__(self, get_batch: Callable[[int], dict],
                 segments: Iterable[Tuple[int, int]], depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._get_batch = get_batch
        self._segments = list(segments)
        self._device = _default_device(device)
        if self._device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self._device)
            # one more than may wait in the queue: the one being filled
            self._slots = [_PinnedSlot() for _ in range(depth + 1)]
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._work,
                                        name="host-prefetch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _put(self, item) -> bool:
        """Enqueue, but never block past a stop request."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, pinned: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Start the copies of ``pinned`` to the card on the copy stream."""
        with torch.cuda.stream(self._copy_stream):
            return {key: t.to(self._device, non_blocking=True) for key, t in pinned.items()}

    def _build(self, n: int, step: int, k: int):
        """Chunk ``n`` of the plan, on the device, and the event to wait on."""
        if k < 1:
            raise ValueError(f"chunk length must be >= 1, got {k}")
        batches = [self._get_batch(step + i) for i in range(k)]
        if self._device.type != "cuda":
            return {key: torch.from_numpy(a) for key, a in _stack(batches).items()}, None
        slot = self._slots[n % len(self._slots)]
        chunk = self._to_device(slot.fill(batches))
        ready = torch.cuda.Event()
        ready.record(self._copy_stream)
        slot.copied = ready
        return chunk, ready

    def _work(self) -> None:
        try:
            for n, (step, k) in enumerate(self._segments):
                if self._stop.is_set():
                    return
                with tracing.span("repro.prefetch.build"):
                    chunk, ready = self._build(n, step, k)
                if not self._put(("chunk", (step, k, chunk, ready))):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
            self._put(("error", exc))
        else:
            self._put(self._DONE)

    # ----------------------------------------------------------- consumer
    def _get(self):
        """The worker's next item, or None if the worker is gone without one."""
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive():
                    # defensive: a worker can only vanish without a terminal
                    # item if close() raced us — stop iterating either way
                    return None

    def __iter__(self) -> Iterator[Tuple[int, int, Dict[str, torch.Tensor]]]:
        while True:
            with tracing.span("repro.loop.prefetch_wait"):
                item = self._get()
            if item is None:
                return
            kind, payload = item
            if kind == "chunk":
                step, k, chunk, ready = payload
                if ready is not None:
                    # the consumer's stream reads the chunk after its copy,
                    # and the allocator frees it only after that stream's use
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(ready)
                    for t in chunk.values():
                        t.record_stream(stream)
                yield step, k, chunk
            elif kind == "error":
                self.close()
                raise payload
            else:  # done
                return

    # ------------------------------------------------------------ cleanup
    def close(self) -> None:
        """Stop the worker, join it, drop any queued chunks.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()
        self._thread.join(timeout=30.0)
        self._drain()  # the worker may have slipped one item in before exiting

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def __enter__(self) -> "HostPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def chunk_stream(get_batch: Callable[[int], dict],
                 segments: Sequence[Tuple[int, int]], prefetch: bool = True,
                 depth: int = 2, device=None
                 ) -> Iterator[Tuple[int, int, Dict[str, torch.Tensor]]]:
    """Yield ``(first_step, k, chunk)`` for each planned segment, the chunk's
    tensors on ``device`` (the card by default).

    ``prefetch=True`` routes through :class:`HostPrefetcher`; ``False`` is
    the synchronous path (identical chunks, host work on the critical path).
    """
    device = _default_device(device)
    if not prefetch:
        for step, k in segments:
            with tracing.span("repro.prefetch.build"):
                chunk = {key: torch.from_numpy(a).to(device)
                         for key, a in stack_batches(get_batch, step, k).items()}
            yield step, k, chunk
        return
    with HostPrefetcher(get_batch, segments, depth=depth, device=device) as pf:
        yield from pf
