"""Multi-replica serving tier, port of ``repro.serve.tier``: replica pool,
work stealing, SLO batching.

The fleet-scale layer above :class:`repro_torch.serve.scheduler.MicroBatcher`.
One :class:`ServeTier` owns a pool of replica worker threads — each with a
per-replica queue and per-replica warmed engine handles
(``ServeEngine.clone``) — in front of a shared
:class:`repro_torch.serve.registry.ModelRegistry`, so one tier concurrently
serves every registered model (e.g. several Pareto-selected operating
points) and survives hot-swaps under load.

Scheduling, in the order a request experiences it:

1. **Admission** — ``submit`` counts every not-yet-served request in the
   tier against ``ServeConfig.max_queue``.  Past the bound,
   ``overload_policy="reject"`` raises :class:`RejectedError` at the
   caller; ``"shed-oldest"`` admits the newcomer and instead fails the
   *globally oldest* queued request's future with :class:`RejectedError`
   (fresh work has a live deadline; the oldest has already eaten its SLO).
   Either way the backlog — and therefore the p99 of everything actually
   served — stays bounded under overload.
2. **Routing** — admitted requests join the shortest replica queue
   (join-shortest-queue), tagged with their model name and an absolute
   deadline (explicit ``deadline_ms``, else ``slo_ms`` from config, else
   none).
3. **Coalescing from deadline buckets** — a replica orders its queue by
   (deadline bucket, arrival), buckets being ``max_delay_ms``-wide slices
   of absolute deadline, so the batch forms around the *soonest-due* work
   (deadline-less requests sort last).  It then gathers up to ``max_batch``
   same-model requests in that order — batches never mix models — waiting
   out the remainder of the head request's coalescing window if the batch
   is not yet full.
4. **Work stealing** — a replica with an empty queue takes the *oldest
   half* of the deepest other queue before sleeping, so a burst routed to
   one replica spreads across the pool instead of serializing behind it.
5. **Execution** — the batch is padded to the power-of-two ladder
   (``pad_batch``), run on the replica's cloned handle of the model's
   engine under a registry **lease** (pinning that engine version across
   any concurrent hot-swap), copied to the host once (``.cpu()``) and
   scattered row-by-row to the request futures.

On one card the replicas time-multiplex, as the reference's do on one
device: every replica thread launches on its current stream, the default
stream, so kernel B4's launches serialize and a replica's host copy waits
for the work other replicas queued before it.

``stats()`` returns a frozen :class:`TierStats` (per-model counts,
stealing/shedding counters, deadline misses, latency percentiles).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.parallel.sharding import pad_batch
from repro_torch.serve.registry import ModelRegistry
from repro_torch.serve.scheduler import (RejectedError, ServeConfig,
                                         _StatsView, bucket_for,
                                         bucket_ladder, host_rows)

_NO_DEADLINE = float("inf")


@dataclasses.dataclass
class TierConfig:
    """Tier shape: replica count + the per-replica scheduling posture.

    ``serve`` is the same :class:`ServeConfig` the single-engine
    micro-batcher takes — ``max_batch`` / ``max_delay_ms`` govern each
    replica's coalescer, ``max_queue`` / ``overload_policy`` the tier-wide
    admission bound, ``slo_ms`` the default request deadline.
    """

    n_replicas: int = 2
    steal: bool = True          # idle replicas raid the deepest queue
    warmup: bool = True         # warm every model's bucket ladder at start()
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)

    def __post_init__(self):
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {self.n_replicas}")


@dataclasses.dataclass(frozen=True)
class TierStats(_StatsView):
    """Frozen snapshot of tier activity (``.as_dict()`` for a plain dict)."""

    n_replicas: int = 0
    n_requests: int = 0
    n_batches: int = 0
    n_rejected: int = 0          # refused at admission (reject policy)
    n_shed: int = 0              # evicted from the queue (shed-oldest)
    n_stolen: int = 0            # requests moved between replicas
    deadline_misses: int = 0     # served after their absolute deadline
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    max_ms: float = 0.0
    mean_batch_fill: float = 0.0
    pad_overhead: float = 0.0
    per_model: Dict[str, int] = dataclasses.field(default_factory=dict)
    per_replica_batches: Tuple[int, ...] = ()


class _TierRequest:
    __slots__ = ("codes", "model", "deadline", "t_enqueue", "future")

    def __init__(self, codes: np.ndarray, model: str, deadline: float):
        self.codes = codes
        self.model = model
        self.deadline = deadline           # absolute monotonic, inf = none
        self.t_enqueue = time.monotonic()
        self.future: Future = Future()


class ServeTier:
    """Replica pool + admission control over a :class:`ModelRegistry`."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 config: Optional[TierConfig] = None):
        self.registry = registry if registry is not None else ModelRegistry()
        self.config = config or TierConfig()
        bucket_ladder(self.config.serve.max_batch)   # validate power of two
        n = self.config.n_replicas
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: List[List[_TierRequest]] = [[] for _ in range(n)]
        self._threads: List[threading.Thread] = []
        self._closed = True
        self._n_pending = 0
        # replica-local engine handle caches: {model: (version, engine)}
        self._handles: List[Dict[str, Tuple[int, object]]] = [
            {} for _ in range(n)]
        # counters (under _lock)
        self._n_rejected = 0
        self._n_shed = 0
        self._n_stolen = 0
        self._deadline_misses = 0
        self._latencies_s: List[float] = []
        self._batch_fill: List[int] = []
        self._batch_bucket: List[int] = []
        self._per_model: Dict[str, int] = {}
        self._per_replica_batches = [0] * n

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeTier":
        if self._threads:
            raise RuntimeError("tier already started")
        if self.config.warmup:
            ladder = bucket_ladder(self.config.serve.max_batch)
            for name in self.registry.names():
                entry = self.registry.acquire(name)
                try:
                    if hasattr(entry.engine, "warm"):
                        entry.engine.warm(ladder)
                finally:
                    self.registry.release(entry)
        self._closed = False
        for k in range(self.config.n_replicas):
            t = threading.Thread(target=self._replica_loop, args=(k,),
                                 name=f"serve-replica-{k}", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def stop(self) -> None:
        """Serve everything already admitted, then join the pool."""
        if not self._threads:
            return
        with self._work:
            self._closed = True
            self._work.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []
        # backstop: fail anything a race left queued, loudly
        with self._lock:
            stranded = [r for q in self._queues for r in q]
            for q in self._queues:
                q.clear()
        for r in stranded:
            r.future.set_exception(
                RuntimeError("tier stopped before request ran"))

    def __enter__(self) -> "ServeTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit
    def submit(self, codes, model: Optional[str] = None, *,
               deadline_ms: Optional[float] = None) -> Future:
        """Route one request: codes (+ model name) -> Future of its output.

        ``model`` may be omitted only when exactly one model is registered.
        ``deadline_ms`` is relative-to-now; absent, ``ServeConfig.slo_ms``
        applies (absent too, the request has no deadline and sorts last in
        every bucket).
        """
        if model is None:
            names = self.registry.names()
            if len(names) != 1:
                raise ValueError(
                    f"model= is required when {len(names)} models are "
                    f"registered (have: {names})")
            model = names[0]
        # resolve n_inputs via a short lease so a bad name fails here, at
        # the caller, not inside a replica thread
        entry = self.registry.acquire(model)
        try:
            n_inputs = entry.engine.n_inputs
        finally:
            self.registry.release(entry)
        codes = np.asarray(codes, np.int64)
        if codes.ndim != 1 or codes.shape[0] != n_inputs:
            raise ValueError(
                f"request for model {model!r} must be ({n_inputs},) codes, "
                f"got shape {codes.shape}")
        if deadline_ms is None:
            deadline_ms = self.config.serve.slo_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else _NO_DEADLINE)
        req = _TierRequest(codes, model, deadline)
        shed: Optional[_TierRequest] = None
        with self._work:
            if self._closed:
                raise RuntimeError("tier is not running")
            mq = self.config.serve.max_queue
            if mq is not None and self._n_pending >= mq:
                if self.config.serve.overload_policy == "reject":
                    self._n_rejected += 1
                    raise RejectedError(
                        f"tier queue full ({self._n_pending}/{mq}) — "
                        f"overload_policy='reject'")
                shed = self._shed_oldest_locked()
            self._queues[self._route_locked()].append(req)
            self._n_pending += 1
            self._work.notify_all()
        if shed is not None:
            # fail outside the lock: future callbacks must not re-enter
            shed.future.set_exception(RejectedError(
                "shed by overload_policy='shed-oldest' (oldest queued "
                "request evicted to admit fresh work)"))
        return req.future

    def _route_locked(self) -> int:
        """Join-shortest-queue: the replica with the fewest queued requests."""
        return min(range(len(self._queues)), key=lambda i: len(self._queues[i]))

    def _shed_oldest_locked(self) -> Optional[_TierRequest]:
        oldest: Optional[_TierRequest] = None
        oldest_at: Optional[int] = None
        for k, q in enumerate(self._queues):
            for r in q:
                if oldest is None or r.t_enqueue < oldest.t_enqueue:
                    oldest, oldest_at = r, k
        if oldest is None:       # bound hit with everything mid-batch
            self._n_rejected += 1
            raise RejectedError(
                "tier saturated with in-flight batches; nothing left "
                "to shed")
        self._queues[oldest_at].remove(oldest)
        self._n_pending -= 1
        self._n_shed += 1
        return oldest

    # --------------------------------------------------------- replica loop
    def _bucket_key(self, r: _TierRequest) -> Tuple[float, float]:
        # deadline buckets are max_delay_ms-wide slices of absolute
        # deadline: soonest-due bucket first, FIFO within a bucket
        width = max(self.config.serve.max_delay_ms, 1e-3) / 1e3
        b = (r.deadline // width) if r.deadline != _NO_DEADLINE else _NO_DEADLINE
        return (b, r.t_enqueue)

    def _replica_loop(self, k: int) -> None:
        cfg = self.config.serve
        delay_s = cfg.max_delay_ms / 1e3
        while True:
            with self._work:
                while not self._queues[k] and not self._closed:
                    if self.config.steal and self._steal_locked(k):
                        break
                    self._work.wait(timeout=0.05)
                if not self._queues[k]:
                    if self._closed:
                        return
                    continue
                # deadline-bucket order, then coalesce the head's model
                self._queues[k].sort(key=self._bucket_key)
                head = self._queues[k][0]
                flush_at = head.t_enqueue + delay_s
                batch = [r for r in self._queues[k]
                         if r.model == head.model][:cfg.max_batch]
                if len(batch) < cfg.max_batch and not self._closed:
                    wait = flush_at - time.monotonic()
                    if wait > 0:
                        self._work.wait(timeout=wait)
                        continue     # re-sort and re-gather after the wait
                for r in batch:
                    self._queues[k].remove(r)
            self._run_batch(k, batch)

    def _steal_locked(self, k: int) -> bool:
        """Move the oldest half of the deepest other queue to replica k."""
        depth, victim = 0, -1
        for j, q in enumerate(self._queues):
            if j != k and len(q) > depth:
                depth, victim = len(q), j
        if depth < 2:            # a single queued request is not worth a raid
            return False
        q = self._queues[victim]
        q.sort(key=lambda r: r.t_enqueue)
        take = q[:depth // 2 + depth % 2]
        self._queues[victim] = q[len(take):]
        self._queues[k].extend(take)
        self._n_stolen += len(take)
        return True

    def _run_batch(self, k: int, batch: List[_TierRequest]) -> None:
        try:
            entry = self.registry.acquire(batch[0].model)
        except BaseException as e:   # model unregistered while queued
            for r in batch:
                r.future.set_exception(e)
            with self._lock:
                self._n_pending -= len(batch)
            return
        try:
            engine = self._handle(k, entry)
            n = len(batch)
            bucket = bucket_for(n, self.config.serve.max_batch)
            x = pad_batch(np.stack([r.codes for r in batch]), bucket)
            out = host_rows(engine.run(x), n)
            done = time.monotonic()
            with self._lock:
                self._batch_fill.append(n)
                self._batch_bucket.append(bucket)
                self._per_replica_batches[k] += 1
                self._latencies_s.extend(done - r.t_enqueue for r in batch)
                self._per_model[entry.name] = (
                    self._per_model.get(entry.name, 0) + n)
                self._deadline_misses += sum(
                    1 for r in batch if done > r.deadline)
            for i, r in enumerate(batch):
                r.future.set_result(out[i])
        except BaseException as e:
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
        finally:
            self.registry.release(entry)
            with self._work:
                self._n_pending -= len(batch)
                self._work.notify_all()

    def _handle(self, k: int, entry) -> object:
        """Replica-local engine handle for this model version.

        Clones share the canonical engine's runner (its device constants
        and lowered chain) but give each replica its own handle; a hot-swap
        bumps ``entry.version`` so stale clones are dropped at the next
        batch.
        """
        cached = self._handles[k].get(entry.name)
        if cached is not None and cached[0] == entry.version:
            return cached[1]
        engine = entry.engine
        clone = getattr(engine, "clone", None)
        if callable(clone):
            engine = clone()
        self._handles[k][entry.name] = (entry.version, engine)
        return engine

    # ----------------------------------------------------------------- stats
    def stats(self) -> TierStats:
        with self._lock:
            lat = np.asarray(self._latencies_s, np.float64)
            fill = np.asarray(self._batch_fill, np.float64)
            bucket = np.asarray(self._batch_bucket, np.float64)
            base = dict(
                n_replicas=self.config.n_replicas,
                n_rejected=self._n_rejected,
                n_shed=self._n_shed,
                n_stolen=self._n_stolen,
                deadline_misses=self._deadline_misses,
                per_model=dict(self._per_model),
                per_replica_batches=tuple(self._per_replica_batches),
            )
        if lat.size == 0:
            return TierStats(**base)
        return TierStats(
            n_requests=int(lat.size),
            n_batches=int(fill.size),
            p50_ms=float(np.percentile(lat, 50) * 1e3),
            p99_ms=float(np.percentile(lat, 99) * 1e3),
            max_ms=float(lat.max() * 1e3),
            mean_batch_fill=float(fill.mean()),
            pad_overhead=float((bucket - fill).sum() / bucket.sum()),
            **base)
