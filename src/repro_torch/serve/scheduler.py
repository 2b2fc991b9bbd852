"""Async micro-batching scheduler, port of ``repro.serve.scheduler``.

The serving engines are batch processors: one call over ``(B, n_inputs)``
codes, on the card one launch of kernel B4.  Production traffic is many
independent single-row requests arriving at random times.  This module
bridges the two with the standard micro-batching loop:

    submit() -> queue -> collector coalesces -> pad to bucket -> engine
                                                   -> scatter to futures

* **Coalescing** — a collector thread drains the request queue and flushes
  when either the batch is full (``max_batch`` rows) or the *oldest* pending
  request has waited ``max_delay_ms`` (the latency deadline).
* **Power-of-two buckets** — every flush is zero-padded
  (``parallel.sharding.pad_batch``) up to the next power of two, so the
  engine sees at most ``log2(max_batch)+1`` batch sizes;
  :meth:`MicroBatcher.start` runs the whole ladder once through
  ``ServeEngine.warm``, so no request pays a first launch.
* **Splitting** — a backlog larger than ``max_batch`` is flushed as several
  consecutive ``max_batch`` chunks (plus one padded remainder), preserving
  arrival order within the flush.
* **Scatter** — each request holds a ``concurrent.futures.Future``; the
  worker that ran a chunk copies the engine's output to the host once (one
  ``.cpu()`` a batch for a device tensor) and writes row ``k`` to the
  ``k``-th future of that chunk, so correctness is independent of
  completion order with ``n_workers > 1``.
* **Admission control** — with ``ServeConfig.max_queue`` set, a submit that
  would push the number of not-yet-served requests past the bound raises
  :class:`RejectedError` (``overload_policy="reject"``; the tier in
  ``serve/tier.py`` also supports ``"shed-oldest"``).
* **Errors** — an engine exception is set on every future of its batch;
  nothing is retried or rerouted.

The scheduler is engine-agnostic: anything with ``run((B, n) int codes) ->
(B, m)`` (a device tensor or a numpy array) and an ``n_inputs`` attribute
serves.  :class:`BatcherConfig` is the deprecated pre-tier name of
:class:`ServeConfig`; ``stats()`` returns a frozen :class:`SchedulerStats`.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import pad_batch


class RejectedError(RuntimeError):
    """Request refused by admission control (bounded queue overflow).

    Raised by ``submit`` under ``overload_policy="reject"`` when the queue
    already holds ``max_queue`` not-yet-served requests, and set as the
    exception of a *shed* request's future under ``"shed-oldest"`` (tier
    only).  Catching it is the backpressure signal: the service is saturated
    and the caller should slow down or retry elsewhere — p99 of everything
    actually served stays bounded instead of growing with the backlog.
    """


def bucket_ladder(max_batch: int) -> List[int]:
    """Power-of-two bucket sizes ``[1, 2, 4, ..., max_batch]``."""
    if max_batch < 1 or max_batch & (max_batch - 1):
        raise ValueError(f"max_batch must be a power of two, got {max_batch}")
    return [1 << k for k in range(max_batch.bit_length())]


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest ladder bucket holding ``n`` rows (n <= max_batch)."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


_OVERLOAD_POLICIES = ("reject", "shed-oldest")


@dataclasses.dataclass
class ServeConfig:
    """Typed scheduler configuration (single engine and per-tier-replica).

    The first four fields are the classic micro-batcher knobs; the last
    three are the overload/SLO posture added with the serving tier:

    * ``max_queue`` — admission bound on not-yet-served requests.  ``None``
      (default) queues unboundedly; a bound makes overload explicit —
      :class:`RejectedError` under ``"reject"``, oldest-request shedding
      under ``"shed-oldest"`` (tier only).
    * ``slo_ms`` — default per-request deadline.  The tier's coalescer
      forms batches from deadline buckets soonest-first; a request with no
      explicit deadline gets ``now + slo_ms`` (or no deadline when None).
    * ``overload_policy`` — what happens at the ``max_queue`` bound.
    """

    max_batch: int = 256        # largest bucket (power of two)
    max_delay_ms: float = 2.0   # deadline: oldest request never waits longer
    n_workers: int = 1          # engine-call threads (>1 => overlapped flushes)
    warmup: bool = True         # run every bucket size once at start()
    max_queue: Optional[int] = None       # admission bound; None = unbounded
    slo_ms: Optional[float] = None        # default request deadline
    overload_policy: str = "reject"       # "reject" | "shed-oldest"

    def __post_init__(self):
        if self.overload_policy not in _OVERLOAD_POLICIES:
            raise ValueError(
                f"overload_policy must be one of {_OVERLOAD_POLICIES}, "
                f"got {self.overload_policy!r}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


class BatcherConfig(ServeConfig):
    """Deprecated pre-tier name of :class:`ServeConfig` (shim).

    Construction works exactly as before and returns a full
    :class:`ServeConfig`, but emits a :class:`DeprecationWarning` — new code
    spells it ``ServeConfig`` (``serve/api.py`` passes it to both the
    single-engine :class:`MicroBatcher` and the tier's replicas).
    """

    def __post_init__(self):
        warnings.warn(
            "BatcherConfig is deprecated; use repro_torch.serve.ServeConfig "
            "(same fields plus max_queue/slo_ms/overload_policy)",
            DeprecationWarning, stacklevel=3)
        super().__post_init__()


class _StatsView:
    """Mixin: frozen-dataclass stats convertible to a plain dict."""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SchedulerStats(_StatsView):
    """Latency/occupancy summary of one :class:`MicroBatcher`.

    Latency percentiles are over everything *served*; ``n_rejected`` counts
    submits refused by admission control (those never enter the latency
    distribution — that is the point of bounding the queue).
    """

    n_requests: int = 0
    n_batches: int = 0
    n_rejected: int = 0
    engine_path: Optional[str] = None
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    max_ms: float = 0.0
    mean_batch_fill: float = 0.0
    mean_bucket: float = 0.0
    pad_overhead: float = 0.0


class _Request:
    __slots__ = ("codes", "future", "t_enqueue")

    def __init__(self, codes: np.ndarray):
        self.codes = codes
        self.future: Future = Future()
        self.t_enqueue = time.monotonic()


_STOP = object()
# bound on the open-loop driver's wait for each response
_RESULT_TIMEOUT_S = 120.0


def host_rows(out, n: int) -> np.ndarray:
    """The first ``n`` rows of an engine's output as a numpy array: one
    host copy (``.cpu()``) of a device tensor, a numpy result as it is."""
    if isinstance(out, torch.Tensor):
        return out[:n].cpu().numpy()
    return np.asarray(out)[:n]


class InterpreterBackend:
    """``DaisProgram.run`` behind the ServeEngine duck-type.

    The baseline the scheduler comparisons swap in: same queue, same
    buckets, same scatter — only the batch processor differs, so a
    "scheduler throughput" number is service-path vs service-path.
    """

    def __init__(self, prog):
        self._prog = prog
        self.n_inputs = len(prog.input_f)

    def run(self, x):
        return self._prog.run(x)


def compare_under_load(prog, engine, codes, config: "ServeConfig",
                       rates) -> List[dict]:
    """Engine vs interpreter behind the *identical* scheduler, under load.

    The load-comparison harness of ``launch/serve.py --serve-loop``: for
    every offered
    rate (req/s; 0 = max-rate burst) it runs the open-loop driver twice —
    once with ``engine``, once with :class:`InterpreterBackend` over
    ``prog`` — asserts both response sets bit-exact against
    ``prog.run(codes)``, and returns one stats row per (rate × backend):
    the :class:`SchedulerStats` fields plus ``backend``, ``offered_rate``,
    ``achieved_rate`` (the rate the driver actually submitted at),
    ``n_requests``, ``rows_per_s``, ``wall_s``, and ``warmup_s``.
    """
    ref = np.asarray(prog.run(codes), np.int64)
    rows = []
    for rate in rates:
        for name, backend in (("engine", engine),
                              ("interp", InterpreterBackend(prog))):
            batcher = MicroBatcher(backend, config)
            t0 = time.monotonic()
            batcher.start()
            warmup_s = time.monotonic() - t0
            out, drive = drive_open_loop(batcher, codes, rate)
            batcher.stop()
            if not np.array_equal(out.astype(np.int64), ref):
                raise AssertionError(
                    f"scheduler/{name} responses diverged from "
                    f"DaisProgram.run — refusing to report its numbers")
            s = batcher.stats().as_dict()
            s.update(backend=name, offered_rate=float(rate),
                     achieved_rate=drive["achieved_rate"],
                     rows_per_s=len(codes) / drive["wall_s"],
                     wall_s=drive["wall_s"], warmup_s=warmup_s)
            rows.append(s)
    return rows


def drive_open_loop(batcher, codes, rate: float, *, submit=None):
    """Submit each row of ``codes`` on an open-loop arrival schedule.

    ``rate`` requests/s, independent of completions (open loop, so queueing
    delay lands in the latency tail instead of throttling the driver);
    ``rate <= 0`` submits everything at once (max-rate burst — measures
    service capacity).

    Pacing is **absolute-deadline**: each request's arrival time is fixed
    on the schedule up front (``t0 + schedule[k]``) and the driver sleeps
    to that absolute instant, so OS sleep overshoot on one request can
    never accumulate into a silently lower offered rate — a late submit is
    followed by an immediate catch-up burst, and the *achieved* submission
    rate is measured and reported next to the requested one instead of
    being assumed.

    ``submit`` overrides the submit callable (default ``batcher.submit``,
    and ``batcher`` may then be None): a tier caller passes a
    model-routing closure.

    Returns ``(results, info)`` where ``info`` is a dict with ``wall_s``
    (submit + drain), ``requested_rate``, ``achieved_rate`` (submission
    side; equals the burst rate when ``rate <= 0``), ``n_requests``, and
    ``max_late_ms`` (worst single-submit lag behind its scheduled instant).
    """
    submit = submit if submit is not None else batcher.submit
    n = len(codes)
    schedule = np.arange(n) / rate if rate > 0 else np.zeros(n)
    t0 = time.monotonic()
    futures = []
    max_late = 0.0
    for k, row in enumerate(codes):
        target = t0 + schedule[k]
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        else:
            max_late = max(max_late, -delay)
        futures.append(submit(row))
    t_last = time.monotonic()
    out = np.stack([f.result(timeout=_RESULT_TIMEOUT_S) for f in futures])
    wall = time.monotonic() - t0
    span = max(t_last - t0, 1e-9)
    info = {
        "wall_s": wall,
        "n_requests": n,
        "requested_rate": float(rate),
        "achieved_rate": (n - 1) / span if n > 1 else float("inf"),
        "max_late_ms": max_late * 1e3,
    }
    return out, info


class MicroBatcher:
    """Queue-in, future-out micro-batching front end for a ServeEngine."""

    def __init__(self, engine, config: Optional[ServeConfig] = None):
        self.engine = engine
        self.config = config or ServeConfig()
        bucket_ladder(self.config.max_batch)  # validate power of two
        if (self.config.max_queue is not None
                and self.config.overload_policy == "shed-oldest"):
            raise ValueError(
                "overload_policy='shed-oldest' is a tier policy "
                "(repro_torch.serve.tier.ServeTier); MicroBatcher supports "
                "'reject'")
        self._queue: "queue.Queue" = queue.Queue()
        self._collector: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = False
        self._lock = threading.Lock()
        # serializes submit's closed-check+enqueue against stop's close, so
        # every accepted request is queued ahead of the _STOP sentinel
        self._submit_lock = threading.Lock()
        self._n_pending = 0          # admitted, not yet served (admission)
        self._n_rejected = 0
        self._latencies_s: List[float] = []
        self._batch_fill: List[int] = []
        self._batch_bucket: List[int] = []

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "MicroBatcher":
        if self._collector is not None:
            raise RuntimeError("scheduler already started")
        if self.config.warmup and hasattr(self.engine, "warm"):
            self.engine.warm(bucket_ladder(self.config.max_batch))
        self._closed = False           # a stopped batcher may be restarted
        self._pool = ThreadPoolExecutor(
            max_workers=max(self.config.n_workers, 1),
            thread_name_prefix="serve-engine")
        self._collector = threading.Thread(
            target=self._collect_loop, name="serve-collector", daemon=True)
        self._collector.start()
        return self

    def stop(self) -> None:
        """Drain the queue, run the final flush, join all workers.

        Closing and the ``_STOP`` enqueue happen under ``_submit_lock``, the
        same lock ``submit`` holds across its closed-check + enqueue — so
        every accepted request sits in the queue *ahead of* the sentinel and
        is served by the collector's final drain.  The post-join sweep below
        is a backstop: anything it still finds is failed loudly rather than
        stranded as a forever-pending future.
        """
        if self._collector is None:
            return
        with self._submit_lock:
            self._closed = True
            self._queue.put(_STOP)
        self._collector.join()
        self._pool.shutdown(wait=True)
        self._collector = None
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item.future.set_exception(
                    RuntimeError("scheduler stopped before request ran"))

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------------- submit
    def submit(self, codes) -> Future:
        """Enqueue one request: (n_inputs,) integer codes -> Future of (m,).

        Returns immediately; the future resolves to the request's own output
        row once some micro-batch containing it has run.  With
        ``max_queue`` configured, a submit past the bound raises
        :class:`RejectedError` (admission control) instead of queueing.
        """
        codes = np.asarray(codes, np.int64)
        if codes.ndim != 1 or codes.shape[0] != self.engine.n_inputs:
            raise ValueError(
                f"request must be ({self.engine.n_inputs},) codes, "
                f"got shape {codes.shape}")
        with self._submit_lock:
            if self._closed or self._collector is None:
                raise RuntimeError("scheduler is not running")
            mq = self.config.max_queue
            if mq is not None and self._n_pending >= mq:
                self._n_rejected += 1
                raise RejectedError(
                    f"queue full ({self._n_pending}/{mq} requests pending) "
                    f"— overload_policy='reject'")
            self._n_pending += 1
            req = _Request(codes)
            self._queue.put(req)
        return req.future

    def submit_many(self, codes) -> List[Future]:
        """Enqueue each row of (N, n_inputs) as an independent request."""
        return [self.submit(row) for row in np.asarray(codes, np.int64)]

    # ------------------------------------------------------------- collector
    def _collect_loop(self) -> None:
        cfg = self.config
        deadline = cfg.max_delay_ms / 1e3
        pending: List[_Request] = []
        stop = False
        while not stop:
            if not pending:
                item = self._queue.get()           # idle: block indefinitely
                if item is _STOP:
                    break
                pending.append(item)
            # greedily drain the backlog that already arrived — under load
            # the oldest deadline has usually passed, and flushing 1-row
            # batches while the queue holds hundreds would waste every
            # engine call (the split below handles > max_batch)
            while not stop:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                else:
                    pending.append(item)
            # then fill until the batch is full or the oldest request's
            # coalescing deadline expires
            flush_at = pending[0].t_enqueue + deadline
            while not stop and len(pending) < cfg.max_batch:
                wait = flush_at - time.monotonic()
                if wait <= 0:
                    break
                try:
                    item = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                    break
                pending.append(item)
            # flush everything collected, in max_batch-sized chunks (split
            # path for backlogs larger than the biggest bucket)
            while pending:
                chunk = pending[:cfg.max_batch]
                pending = pending[cfg.max_batch:]
                self._pool.submit(self._run_chunk, chunk)
        # drain whatever raced the stop signal
        final: List[_Request] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                final.append(item)
        while final:
            self._pool.submit(self._run_chunk, final[:cfg.max_batch])
            final = final[cfg.max_batch:]

    # ----------------------------------------------------------- engine call
    def _run_chunk(self, chunk: List[_Request]) -> None:
        try:
            n = len(chunk)
            bucket = bucket_for(n, self.config.max_batch)
            x = pad_batch(np.stack([r.codes for r in chunk]), bucket)
            out = host_rows(self.engine.run(x), n)
            done = time.monotonic()
            with self._lock:
                self._batch_fill.append(n)
                self._batch_bucket.append(bucket)
                self._latencies_s.extend(done - r.t_enqueue for r in chunk)
            for k, req in enumerate(chunk):
                req.future.set_result(out[k])
        except BaseException as e:  # propagate to every caller, don't die
            for req in chunk:
                if not req.future.done():
                    req.future.set_exception(e)
        finally:
            with self._submit_lock:
                self._n_pending -= len(chunk)

    # ------------------------------------------------------------------ stats
    def stats(self) -> SchedulerStats:
        """Typed latency/occupancy summary over everything served so far.

        Returns a frozen :class:`SchedulerStats` (``.as_dict()`` for a
        plain dict).
        """
        with self._lock:
            lat = np.asarray(self._latencies_s, np.float64)
            fill = np.asarray(self._batch_fill, np.float64)
            bucket = np.asarray(self._batch_bucket, np.float64)
        engine_path = getattr(self.engine, "path", None)
        with self._submit_lock:
            n_rejected = self._n_rejected
        if lat.size == 0:
            return SchedulerStats(engine_path=engine_path,
                                  n_rejected=n_rejected)
        return SchedulerStats(
            engine_path=engine_path,
            n_requests=int(lat.size),
            n_batches=int(fill.size),
            n_rejected=n_rejected,
            p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3),
            max_ms=float(lat.max() * 1e3),
            mean_batch_fill=float(fill.mean()),
            mean_bucket=float(bucket.mean()),
            pad_overhead=float((bucket - fill).sum() / bucket.sum()),
        )
