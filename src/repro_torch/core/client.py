"""The unified two-layer cache API: kernel engine + ``CacheClient``.

The paper's engine is a pure observe→recognize→adapt state machine; the
I/O contract around it — who fetches missed bytes, who runs prefetch
candidates, who calls ``complete_prefetch`` when background bytes land —
was re-implemented by every consumer (the cluster simulator's event loop,
the token pipeline's ad-hoc worker thread, raw loops in the examples).
This module absorbs that contract behind one client interface (IGTCache
§2's "no code intrusion" claim; Hoard arXiv:1812.00669 draws the same
line between cache kernel and client library).

Two layers:

**Kernel layer** — the engine itself (``IGTCache`` / ``ShardedIGTCache``),
a deterministic single-threaded state machine with the documented surface

    read / read_batch / complete_prefetch / cancel_prefetch / tick /
    pin / never_cache / stats / hit_ratio / snapshot / iter_workload_cmus

The kernel never does I/O, never imports the storage layer, and never
owns time: every call takes ``now``.  This is the property-test surface
(tests/test_equivalence.py) and stays available for callers that need
full control (the discrete-event simulator owns bandwidth, so it drives
the kernel through the client with a link-backed executor; see
``sim.cluster.LinkExecutor``).

**Client layer** — ``CacheClient`` wraps a kernel with

  * a pluggable backing store on the **v2 storage protocol**
    (``storage.api.BackingStore``: ``fetch_range`` / ``fetch_many`` /
    ``capabilities``) that supplies actual bytes — partial-extent reads
    fetch exact sub-block ranges instead of over-fetching whole blocks,
    and batched reads funnel their demand misses through one
    ``fetch_many`` call; legacy one-method ``fetch_block`` stores are
    adapted transparently (``storage.api.as_backing_store``);
  * a :class:`RetryPolicy`-guarded fetch path: transient store errors
    (``storage.api.TransientStoreError``) retry with bounded backoff,
    permanent errors propagate to the blocked reader and *cancel* the
    affected prefetch candidates on the kernel, so the executor identity
    ``submitted == completed + cancelled + deduped`` and the kernel
    pending table survive a failing backend;
  * a :class:`PrefetchExecutor` that runs the kernel's prefetch
    candidates: the deterministic inline :class:`SimExecutor` (virtual
    clock; bitwise-equivalent to the caller-driven loop) or the
    :class:`ThreadedExecutor` (one worker per kernel shard — shards share
    no read-path state — bounded queues, demand-miss > prefetch priority,
    in-queue dedup, and cancellation that calls ``cancel_prefetch`` on
    overflow/shutdown instead of silently dropping candidates).

``open_cache(store_or_uri, capacity, ...) -> CacheClient`` is the one
constructor path all consumers share; ``store`` may be a store instance
or a URI for the scheme registry (``"sim://default"``,
``"file:///data"``, ``"mem://"``, ``"faulty+sim://..."`` — see
``storage.api.open_store``).  Every future scaling lever (multi-process
shards, S3/GCS adapters) plugs in behind these two protocols.  See
docs/API.md for the full contract.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple, Union)

import numpy as np

from .cache import path_key
from .faults import SHARD_UP, ShardUnavailableError
from .igtcache import BlockResult, EngineOptions, ReadOutcome
from .sharded import Engine, ShardedIGTCache, make_engine
from .types import CacheConfig, PathT, block_key

__all__ = [
    "BackingStore", "CacheClient", "ClientStats", "ExecutorStats",
    "KernelGuard", "NullExecutor", "PrefetchExecutor", "ReadResult",
    "SimExecutor", "ThreadedExecutor", "open_cache",
]

# One demand fetch: (file-or-block path, offset within it, length) — the
# same shape as storage.api.RangeRequest (kept structural so the kernel
# package does not import the storage package at import time).
RangeRequest = Tuple[PathT, int, int]


class BackingStore:
    """Legacy (v1) byte-source protocol: one method
    ``fetch_block(block_path, size) -> np.ndarray[uint8]`` returning the
    first ``size`` bytes of the block at ``block_path``.

    Kept for third-party stores written against the PR-3 API — the
    client adapts them via ``storage.api.as_backing_store``.  New
    backends should implement the ranged/batched v2 protocol
    (``storage.api.BackingStore``) instead.
    """

    def fetch_block(self, block_path: PathT,
                    size: int) -> np.ndarray:  # pragma: no cover - protocol
        raise NotImplementedError


@dataclass
class ExecutorStats:
    """Candidate accounting for one executor (lost-candidate audit trail:
    ``submitted == completed + cancelled + deduped + in_flight``)."""

    submitted: int = 0        # candidates handed to submit()
    completed: int = 0        # complete_prefetch delivered to the kernel
    cancelled: int = 0        # cancel_prefetch on overflow/shutdown/failure
    deduped: int = 0          # dropped: same block already queued/in flight
    demand_fetches: int = 0   # priority demand-miss range fetches served
    retries: int = 0          # transient store errors absorbed by RetryPolicy
    fetch_errors: int = 0     # fetches that failed past the retry bound

    def snapshot(self) -> dict:
        return {"submitted": self.submitted, "completed": self.completed,
                "cancelled": self.cancelled, "deduped": self.deduped,
                "demand_fetches": self.demand_fetches,
                "retries": self.retries, "fetch_errors": self.fetch_errors}


@dataclass
class ClientStats:
    """Degraded-path accounting for one :class:`CacheClient`.

    Counts reads the client served *around* the kernel while a shard was
    down/restarting (bytes came straight from the backing store, no
    cache observation happened) — the availability cost a fault leaves
    behind.  ``fallback_fetches`` counts demand fetches that started on
    the executor and finished on the store after the shard died between
    the kernel read and the byte fetch."""

    degraded_reads: int = 0       # read requests served without the kernel
    degraded_bytes: int = 0       # bytes fetched via the degraded path
    fallback_fetches: int = 0     # executor demand fetches re-run direct

    def snapshot(self) -> dict:
        return {"degraded_reads": self.degraded_reads,
                "degraded_bytes": self.degraded_bytes,
                "fallback_fetches": self.fallback_fetches}


class KernelGuard:
    """Per-shard mutual exclusion for the kernel.

    The kernel is a single-threaded state machine; a ``ShardedIGTCache``
    is N independent ones (shards share no read-path state, so per-shard
    locks give shard-parallel readers/completers).  Cross-shard
    operations (``tick`` with the global rebalancer, ``pin``) take all
    locks in index order.  For a plain ``IGTCache`` there is one lock.
    """

    def __init__(self, engine: Engine) -> None:
        self.engine = engine
        # duck-typed: any sharded driver (in-process facade or the
        # multi-process ProcessShardedCache) exposes n_shards + shard_id
        n = getattr(engine, "n_shards", 1)
        self._locks = [threading.Lock() for _ in range(n)]
        self._sharded = n > 1

    @property
    def n_shards(self) -> int:
        return len(self._locks)

    def shard_id(self, path: PathT) -> int:
        if not self._sharded:
            return 0
        return self.engine.shard_id(path)

    def lock_for(self, path: PathT) -> threading.Lock:
        return self._locks[self.shard_id(path)]

    def lock_shard(self, sid: int) -> threading.Lock:
        return self._locks[sid]

    def acquire_all(self) -> None:
        for lk in self._locks:          # fixed order: no deadlock
            lk.acquire()

    def release_all(self) -> None:
        for lk in reversed(self._locks):
            lk.release()


class PrefetchExecutor:
    """Protocol + shared plumbing for prefetch candidate execution.

    Lifecycle: constructed unattached (configuration only), then
    ``attach``-ed exactly once by the :class:`CacheClient` that owns it.
    ``submit`` receives the candidates of one read at timestamp ``now``;
    the executor must eventually either ``complete_prefetch`` or
    ``cancel_prefetch`` every candidate on the kernel — never drop one
    silently (the kernel tracks pending candidates for dedup, so a
    dropped candidate blocks that block's re-issue forever).  A fetch
    that fails past the retry bound counts as ``cancel``, keeping the
    identity intact under a failing backend.
    """

    def __init__(self) -> None:
        self.stats = ExecutorStats()
        self.engine: Optional[Engine] = None
        self.backing = None               # storage.api.BackingStore or None
        self.guard: Optional[KernelGuard] = None
        self.clock: Callable[[], float] = time.monotonic
        self.retry = None                 # storage.api.RetryPolicy
        self._stats_lock = threading.Lock()

    def attach(self, engine: Engine, backing, guard: KernelGuard,
               clock: Callable[[], float], retry=None) -> None:
        if self.engine is not None and self.engine is not engine:
            raise RuntimeError("executor is already attached to a kernel")
        self.engine = engine
        self.backing = backing
        self.guard = guard
        self.clock = clock
        if retry is not None:
            self.retry = retry
        elif self.retry is None:
            from ..storage.api import RetryPolicy
            self.retry = RetryPolicy()

    # -- candidate path -----------------------------------------------------
    def submit(self, candidates: Sequence[Tuple[PathT, int]],
               now: float) -> None:  # pragma: no cover - protocol
        raise NotImplementedError

    # -- fetch plumbing -----------------------------------------------------
    def _note_retry(self, attempt: int, exc: BaseException) -> None:
        with self._stats_lock:
            self.stats.retries += 1

    def fetch_ranges(self, requests: Sequence[RangeRequest]
                     ) -> List[np.ndarray]:
        """Retry-guarded raw range fetch (one ``fetch_many`` call)."""
        assert self.backing is not None, "byte fetch needs a backing store"
        try:
            return self.retry.call(self.backing.fetch_many, requests,
                                   on_retry=self._note_retry)
        except BaseException:
            with self._stats_lock:
                self.stats.fetch_errors += 1
            raise

    # -- demand path (priority over prefetch) -------------------------------
    def fetch_demand(self, requests: Sequence[RangeRequest]
                     ) -> List[np.ndarray]:
        """Fetch demand-missed ranges; must preempt queued prefetches."""
        with self._stats_lock:
            self.stats.demand_fetches += len(requests)
        return self.fetch_ranges(requests)

    # -- lifecycle ----------------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted candidate completed or cancelled."""
        return True

    def close(self, cancel_pending: bool = True) -> None:
        pass


class SimExecutor(PrefetchExecutor):
    """Deterministic inline executor for virtual-clock callers.

    ``submit`` completes every candidate synchronously at the read's own
    ``now`` — exactly the caller-driven loop the discrete-event tests and
    the non-threaded pipeline ran by hand, so a client with a SimExecutor
    is bitwise-equivalent to that loop (pinned in
    tests/test_equivalence.py).  ``max_fetch_bytes=0`` (default) moves no
    bytes: pure-simulation callers only track sizes and latencies.  A
    candidate whose (capped) fetch fails past the retry bound is
    cancelled on the kernel instead of completed.
    """

    def __init__(self, max_fetch_bytes: int = 0) -> None:
        super().__init__()
        self.max_fetch_bytes = max_fetch_bytes

    def submit(self, candidates: Sequence[Tuple[PathT, int]],
               now: float) -> None:
        if not candidates:
            return
        self.stats.submitted += len(candidates)
        eng = self.engine
        for path, size in candidates:
            if self.backing is not None and self.max_fetch_bytes > 0:
                try:
                    self.retry.call(self.backing.fetch_range, path, 0,
                                    min(size, self.max_fetch_bytes),
                                    on_retry=self._note_retry)
                except Exception:
                    self.stats.fetch_errors += 1
                    eng.cancel_prefetch(path)
                    self.stats.cancelled += 1
                    continue
            eng.complete_prefetch(path, size, now)
            self.stats.completed += 1


class NullExecutor(PrefetchExecutor):
    """Read-only client: every candidate is cancelled immediately (the
    kernel's pending-table stays clean; nothing is fetched)."""

    def submit(self, candidates: Sequence[Tuple[PathT, int]],
               now: float) -> None:
        if not candidates:
            return
        self.stats.submitted += len(candidates)
        for path, _size in candidates:
            self.engine.cancel_prefetch(path)
            self.stats.cancelled += 1


class _DemandBatch:
    """One shard's slice of a demand fetch: served by that shard's worker
    in a single ``fetch_many`` call (shard-parallel batched fetches)."""

    __slots__ = ("requests", "results", "error", "event")

    def __init__(self, requests: List[RangeRequest]) -> None:
        self.requests = requests
        self.results: Optional[List[np.ndarray]] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class _ShardQueue:
    """Two-class bounded queue for one shard worker.

    Demand batches (missed ranges a reader is blocked on) always pop
    before background prefetch candidates and are never rejected; the
    background class is bounded by ``depth`` and rejects on overflow (the
    caller cancels the candidate on the kernel).  ``keys`` is the
    in-queue / in-flight dedup set for background candidates.
    """

    def __init__(self, depth: int) -> None:
        self.depth = depth
        self.cv = threading.Condition()
        self.demand: Deque[_DemandBatch] = deque()
        self.background: Deque[Tuple[PathT, int, str]] = deque()
        self.keys: Set[str] = set()          # queued + in-flight candidates
        self.outstanding = 0                 # background items not yet done
        self.closed = False

    def put_demand(self, item: _DemandBatch) -> bool:
        with self.cv:
            if self.closed:
                return False
            self.demand.append(item)
            self.cv.notify()
            return True

    def offer_background(self, path: PathT, size: int,
                         key: str) -> str:
        """Returns 'queued' | 'dup' | 'full' | 'closed'."""
        with self.cv:
            if self.closed:
                return "closed"
            if key in self.keys:
                return "dup"
            if len(self.background) >= self.depth:
                return "full"
            self.keys.add(key)
            self.background.append((path, size, key))
            self.outstanding += 1
            self.cv.notify()
            return "queued"

    def get(self, timeout: float):
        with self.cv:
            if not self.demand and not self.background:
                self.cv.wait(timeout)
            if self.demand:
                return self.demand.popleft()
            if self.background:
                return self.background.popleft()
            return None

    def task_done(self, key: str) -> None:
        with self.cv:
            self.keys.discard(key)
            self.outstanding -= 1
            self.cv.notify_all()

    def drain_background(self) -> List[Tuple[PathT, int, str]]:
        with self.cv:
            items = list(self.background)
            self.background.clear()
            for _, _, key in items:
                self.keys.discard(key)
                self.outstanding -= 1
            self.cv.notify_all()
            return items

    def wait_idle(self, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while self.outstanding > 0 or self.demand:
                if self.closed:
                    # a closed queue can only drain via close()'s own
                    # cancellation sweep — report the truth promptly
                    # instead of burning the caller's full timeout
                    return False
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self.cv.wait(rem if rem is not None else 0.1)
        return True


class ThreadedExecutor(PrefetchExecutor):
    """Per-shard background prefetch workers.

    One daemon worker per kernel shard (``IGTCache`` counts as one
    shard); a candidate is routed to its block's shard worker, so
    completions only ever contend with reads of the same shard — the
    multi-worker shard driver from the ROADMAP.  Per-shard queues are
    bounded; an overflowing candidate is *cancelled on the kernel*
    (``cancel_prefetch``) so the pending-table never leaks, and shutdown
    cancels everything still queued.  Demand-miss fetches jump every
    queue (strict priority), are never rejected, and arrive as per-shard
    batches served in one ``fetch_many`` call each.  Background fetches
    ride the client's :class:`RetryPolicy`; a fetch that still fails is
    cancelled on the kernel — the worker survives a failing backend.
    """

    def __init__(self, queue_depth: int = 4096,
                 max_fetch_bytes: int = 4096,
                 poll_s: float = 0.05) -> None:
        super().__init__()
        self.queue_depth = queue_depth
        self.max_fetch_bytes = max_fetch_bytes
        self.poll_s = poll_s
        self._queues: List[_ShardQueue] = []
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        self._closed = False

    # -- lifecycle ----------------------------------------------------------
    def attach(self, engine: Engine, backing, guard: KernelGuard,
               clock: Callable[[], float], retry=None) -> None:
        super().attach(engine, backing, guard, clock, retry)
        if self._started:
            return
        self._started = True
        for sid in range(guard.n_shards):
            q = _ShardQueue(self.queue_depth)
            w = threading.Thread(target=self._run, args=(sid, q),
                                 name=f"igt-prefetch-{sid}", daemon=True)
            self._queues.append(q)
            self._workers.append(w)
            w.start()

    def close(self, cancel_pending: bool = True) -> None:
        self._closed = True             # submit() now raises, not enqueues
        if not self._started or self._stop.is_set():
            return
        if not cancel_pending:
            self.flush()
        for q in self._queues:          # late offers now reject as 'closed'
            with q.cv:
                q.closed = True
        self._cancel_queued()
        self._stop.set()
        for w in self._workers:
            w.join(timeout=2.0)
        # workers are down: anything that slipped between drain and join is
        # cancelled too — a candidate must never be dropped silently —
        # and stranded demand waiters are released with an error
        self._cancel_queued()
        for q in self._queues:
            with q.cv:
                while q.demand:
                    item = q.demand.popleft()
                    item.error = RuntimeError(
                        "ThreadedExecutor closed with the fetch in queue")
                    item.event.set()

    def _cancel_queued(self) -> None:
        for sid, q in enumerate(self._queues):
            for path, _size, _key in q.drain_background():
                with self.guard.lock_shard(sid):
                    self.engine.cancel_prefetch(path)
                with self._stats_lock:
                    self.stats.cancelled += 1

    def flush(self, timeout: Optional[float] = None) -> bool:
        return all(q.wait_idle(timeout) for q in self._queues)

    # -- candidate path -----------------------------------------------------
    def submit(self, candidates: Sequence[Tuple[PathT, int]],
               now: float) -> None:
        if not candidates:
            return
        guard = self.guard
        if self._closed:
            # close-vs-submit race: the queues are dead, so first release
            # every candidate on the kernel (the pending table must never
            # leak), then fail loudly — a silent cancel here would let a
            # caller keep feeding a closed executor forever
            with self._stats_lock:
                self.stats.submitted += len(candidates)
            for path, _size in candidates:
                with guard.lock_for(path):
                    self.engine.cancel_prefetch(path)
                with self._stats_lock:
                    self.stats.cancelled += 1
            raise RuntimeError("submit() on a closed ThreadedExecutor")
        with self._stats_lock:
            self.stats.submitted += len(candidates)
        for path, size in candidates:
            sid = guard.shard_id(path)
            got = self._queues[sid].offer_background(path, size,
                                                     path_key(path))
            if got == "queued":
                continue
            if got == "dup":
                # same block already queued/in flight: this duplicate
                # candidate will never get its own completion — release it
                with guard.lock_shard(sid):
                    self.engine.cancel_prefetch(path)
                with self._stats_lock:
                    self.stats.deduped += 1
            else:  # full / closed → cancel instead of silently dropping
                with guard.lock_shard(sid):
                    self.engine.cancel_prefetch(path)
                with self._stats_lock:
                    self.stats.cancelled += 1

    # -- demand path --------------------------------------------------------
    def fetch_demand(self, requests: Sequence[RangeRequest]
                     ) -> List[np.ndarray]:
        """Split the demand ranges by shard, hand each shard worker its
        slice as one priority batch (served via a single ``fetch_many``),
        and block until every slice lands — misses of one read/batch
        fetch shard-parallel."""
        assert self.backing is not None, "demand fetch needs a backing store"
        with self._stats_lock:
            self.stats.demand_fetches += len(requests)
        by_shard: Dict[int, List[int]] = {}
        for i, req in enumerate(requests):
            by_shard.setdefault(self.guard.shard_id(req[0]), []).append(i)
        batches: List[Tuple[List[int], _DemandBatch]] = []
        for sid, idxs in by_shard.items():
            batch = _DemandBatch([requests[i] for i in idxs])
            batches.append((idxs, batch))
            if not self._queues[sid].put_demand(batch):
                batch.error = RuntimeError(
                    "demand fetch on a closed ThreadedExecutor")
                batch.event.set()
        for _idxs, batch in batches:
            batch.event.wait()
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        for idxs, batch in batches:
            if batch.error is not None:  # re-raise in the reader's thread
                raise batch.error
            for i, data in zip(idxs, batch.results):
                out[i] = data
        return out  # type: ignore[return-value]

    # -- worker loop --------------------------------------------------------
    def _run(self, sid: int, q: _ShardQueue) -> None:
        guard = self.guard
        while not self._stop.is_set():
            got = q.get(self.poll_s)
            if got is None:
                continue
            if isinstance(got, _DemandBatch):
                # a failing backing store must not kill the shard worker
                # or strand the blocked reader: hand the error back
                # through the batch (fetch_ranges already retried
                # transient errors per the RetryPolicy)
                try:
                    got.results = self.fetch_ranges(got.requests)
                except BaseException as e:
                    got.error = e
                finally:
                    got.event.set()
                    with q.cv:
                        q.cv.notify_all()
                continue
            path, size, key = got
            try:
                try:
                    if self.backing is not None and self.max_fetch_bytes > 0:
                        # the actual byte movement (capped: content is what
                        # a real store would stream; the kernel only needs
                        # sizes), transient failures retried
                        self.retry.call(
                            self.backing.fetch_range, path, 0,
                            min(size, self.max_fetch_bytes),
                            on_retry=self._note_retry)
                    with guard.lock_shard(sid):
                        self.engine.complete_prefetch(path, size,
                                                      self.clock())
                    with self._stats_lock:
                        self.stats.completed += 1
                except Exception:
                    # failed past the retry bound → the candidate will
                    # never complete: release it on the kernel, keep the
                    # worker alive
                    with self._stats_lock:
                        self.stats.fetch_errors += 1
                    with guard.lock_shard(sid):
                        self.engine.cancel_prefetch(path)
                    with self._stats_lock:
                        self.stats.cancelled += 1
            finally:
                q.task_done(key)


class ReadResult:
    """One client read: the kernel's per-block outcome plus, when the
    client fetched through its backing store, the requested bytes."""

    __slots__ = ("outcome", "data")

    def __init__(self, outcome: ReadOutcome,
                 data: Optional[np.ndarray] = None) -> None:
        self.outcome = outcome
        self.data = data

    @property
    def blocks(self):
        return self.outcome.blocks

    @property
    def cached_bytes(self) -> int:
        return self.outcome.cached_bytes

    @property
    def remote_bytes(self) -> int:
        return self.outcome.remote_bytes


def _sync_block_size(store, cfg: Optional[CacheConfig]) -> None:
    """Align a store's block geometry with the cache config (walking
    wrapper ``inner`` chains, e.g. ``faulty+file://``).  Only objects
    whose *class* declares an integer ``block_size`` are touched —
    ``__getattr__``-delegating wrappers are skipped in favor of the
    store they wrap, and property-backed geometries are left alone."""
    if cfg is None:
        return
    obj, hops = store, 0
    while obj is not None and hops < 4:
        if (isinstance(getattr(type(obj), "block_size", None), int)
                and obj.block_size != cfg.block_size):
            obj.block_size = cfg.block_size
        obj = obj.__dict__.get("inner") if hasattr(obj, "__dict__") else None
        hops += 1


class CacheClient:
    """The caller layer: reads + prefetch execution over one kernel.

    ``read``/``read_batch`` serve through the kernel under the shard
    guard, hand the kernel's prefetch candidates to the executor, and —
    when asked for bytes — fetch hits locally (exact sub-block ranges)
    and misses through the executor's priority demand path
    (shard-parallel ``fetch_many`` batches under the ThreadedExecutor).
    All kernel introspection (``stats``, ``snapshot``,
    ``iter_workload_cmus``) passes through.

    ``backing`` accepts anything ``storage.api.as_backing_store``
    understands: a v2 store, a legacy one-method ``fetch_block`` store
    (adapted), or ``None`` for metadata-only clients.

    **Degraded-mode reads** (``degraded=True``, the default): when the
    kernel raises :class:`ShardUnavailableError` — a shard worker of the
    multi-process driver died, is restarting, or exhausted its restart
    budget — the client serves the affected requests *around* the
    kernel: it synthesizes an all-miss outcome from the store's file
    geometry and fetches the bytes straight from the backing store, so
    callers always get correct bytes and never hang on a dead worker.
    Only the failed sub-batch degrades; outcomes the surviving shards
    already produced are kept (re-reading would double-observe their
    keys).  Degraded traffic is counted in :class:`ClientStats`.  The
    only error a reader sees is the backing store itself permanently
    failing.  ``breaker`` (a ``storage.api.CircuitBreaker``) optionally
    guards every client-side byte fetch against a store that is failing
    hard: after K consecutive transient failures calls fast-fail with
    ``CircuitOpenError`` until the breaker half-opens.

    Time: pass ``now`` explicitly (virtual-clock callers) or omit it to
    use the client's ``clock`` (default ``time.monotonic``).
    """

    def __init__(self, engine: Engine, *,
                 backing=None,
                 executor: Optional[PrefetchExecutor] = None,
                 clock: Optional[Callable[[], float]] = None,
                 fetch_bytes: bool = False,
                 retry=None,
                 degraded: bool = True,
                 breaker=None) -> None:
        from ..storage.api import RetryPolicy, as_backing_store
        self.engine = engine
        self.backing = as_backing_store(backing)
        # one block geometry everywhere: the kernel plans block paths
        # with cfg.block_size, and stores resolve "#b" leaves with their
        # own block_size — a mismatch would silently return wrong bytes
        _sync_block_size(engine.meta, engine.cfg)
        _sync_block_size(self.backing, engine.cfg)
        self.breaker = breaker
        if retry is not None:
            self.retry = retry
        elif breaker is not None:
            # the default policy adopts the breaker so *every* fetch
            # path (executor workers included) rides it
            self.retry = RetryPolicy(breaker=breaker)
        else:
            self.retry = RetryPolicy()
        self.degraded = degraded
        self.client_stats = ClientStats()
        self._cstats_lock = threading.Lock()
        self.clock = clock or time.monotonic
        self.guard = KernelGuard(engine)
        self.executor = executor if executor is not None else SimExecutor()
        self.executor.attach(engine, self.backing, self.guard, self.clock,
                             self.retry)
        self.fetch_bytes = fetch_bytes
        if fetch_bytes and self.backing is None:
            raise ValueError("fetch_bytes=True needs a backing store")
        self._closed = False
        # open_cache sets this: a client that *constructed* its engine
        # also shuts it down (process-backed drivers own OS resources)
        self._own_engine = False

    # ------------------------------------------------------------------ read
    def read(self, file_path: PathT, offset: int, size: int,
             now: Optional[float] = None, *,
             fetch: Optional[bool] = None) -> ReadResult:
        """Serve one extent: kernel read → executor-dispatched prefetch →
        (optionally) bytes for the requested range.  A dead shard
        degrades to a direct store fetch instead of raising (see the
        class docstring)."""
        if now is None:
            now = self.clock()
        degraded = False
        try:
            with self.guard.lock_for(file_path):
                out = self.engine.read(file_path, offset, size, now)
        except ShardUnavailableError:
            if not self.degraded:
                raise
            out = self._degraded_outcome(file_path, offset, size)
            degraded = True
            with self._cstats_lock:
                self.client_stats.degraded_reads += 1
        if out.prefetches:
            self.executor.submit(out.prefetches, now)
        want = self.fetch_bytes if fetch is None else fetch
        if not want or not out.blocks:
            return ReadResult(out)
        self._require_backing()
        plan = self._plan_ranges(file_path, offset, size, out)
        fetched: Dict[RangeRequest, np.ndarray] = {}
        demand = [r for r, hit in plan if not hit]
        if demand:
            fetched.update(zip(demand,
                               self._fetch_misses(demand, degraded)))
        self._fetch_hits([plan], fetched)
        return ReadResult(out, self._assemble(plan, fetched))

    def read_batch(self, requests: Sequence[Tuple[PathT, int, int]],
                   now: Optional[float] = None, *,
                   fetch: Optional[bool] = None) -> List[ReadResult]:
        """One kernel ``read_batch`` (tick amortized per batch), prefetch
        dispatch per outcome — and, when fetching bytes, *all* demand
        misses of the batch funneled through one ``fetch_demand`` call
        (one ``fetch_many`` per shard under the ThreadedExecutor).  When
        a shard is down only its sub-batch degrades to direct store
        fetches; the surviving shards' outcomes are kept as-is."""
        if now is None:
            now = self.clock()
        requests = list(requests)
        degraded_idx: Set[int] = set()
        self.guard.acquire_all()
        try:
            outs = self.engine.read_batch(requests, now)
        except ShardUnavailableError as e:
            if not self.degraded:
                raise
            # patch only the holes: the error carries the healthy
            # shards' outcomes, and re-issuing them would double-observe
            partial = (e.partial if e.partial is not None
                       else [None] * len(requests))
            holes = (e.indices if e.indices is not None
                     else [i for i, o in enumerate(partial) if o is None])
            outs = list(partial)
            for i in holes:
                fp, off, sz = requests[i]
                outs[i] = self._degraded_outcome(fp, off, sz)
                degraded_idx.add(i)
            with self._cstats_lock:
                self.client_stats.degraded_reads += len(degraded_idx)
        finally:
            self.guard.release_all()
        for out in outs:
            if out.prefetches:
                self.executor.submit(out.prefetches, now)
        want = self.fetch_bytes if fetch is None else fetch
        if not want:
            return [ReadResult(out) for out in outs]
        self._require_backing()
        plans = [self._plan_ranges(fp, off, sz, out) if out.blocks else []
                 for (fp, off, sz), out in zip(requests, outs)]
        all_demand: List[RangeRequest] = []
        direct_demand: List[RangeRequest] = []
        seen: Set[RangeRequest] = set()
        for j, plan in enumerate(plans):
            for r, hit in plan:
                if not hit and r not in seen:
                    seen.add(r)
                    # a degraded request's shard is dead: its misses
                    # must not travel through the executor's worker RPC
                    (direct_demand if j in degraded_idx
                     else all_demand).append(r)
        fetched: Dict[RangeRequest, np.ndarray] = {}
        if all_demand:
            fetched.update(zip(all_demand,
                               self._fetch_misses(all_demand, False)))
        if direct_demand:
            fetched.update(zip(direct_demand,
                               self._fetch_misses(direct_demand, True)))
        self._fetch_hits(plans, fetched)
        return [ReadResult(out,
                           self._assemble(plan, fetched) if plan else None)
                for out, plan in zip(outs, plans)]

    # ------------------------------------------------------- degraded path
    def _degraded_outcome(self, file_path: PathT, offset: int,
                          size: int) -> ReadOutcome:
        """All-miss outcome for a request whose shard kernel is gone,
        built from the store's file geometry (clamped to EOF) — the same
        block decomposition the kernel would have produced, minus any
        caching/prefetching (the kernel never saw the access)."""
        bs = self.engine.cfg.block_size
        try:
            fsize = self.engine.meta.file_size(file_path)
        except Exception:
            fsize = offset + size    # unknown geometry: trust the request
        end = min(offset + size, fsize)
        blocks: List[BlockResult] = []
        if end > offset:
            first = offset // bs
            for b in range(first, (end - 1) // bs + 1):
                blocks.append(BlockResult(
                    path_key(block_key(file_path, b)),
                    min(bs, fsize - b * bs), False))
        return ReadOutcome(blocks, [])

    def _direct_fetch(self, requests: Sequence[RangeRequest]
                      ) -> List[np.ndarray]:
        """Degraded byte path: straight to the backing store, bypassing
        the executor (whose demand path would RPC the dead worker).
        Retry-guarded and breaker-guarded like every other fetch."""
        if self.breaker is not None:
            data = self.retry.call(self.backing.fetch_many, list(requests),
                                   breaker=self.breaker)
        else:   # a caller-supplied policy may not take the breaker kwarg
            data = self.retry.call(self.backing.fetch_many, list(requests))
        with self._cstats_lock:
            self.client_stats.degraded_bytes += sum(r[2] for r in requests)
        return data

    def _fetch_misses(self, demand: List[RangeRequest],
                      degraded: bool) -> List[np.ndarray]:
        """Demand misses via the executor — or, for degraded requests /
        a shard that died after the kernel read, direct from the store
        so the blocked reader still gets its bytes."""
        if degraded:
            return self._direct_fetch(demand)
        try:
            return self.executor.fetch_demand(demand)
        except ShardUnavailableError:
            if not self.degraded:
                raise
            with self._cstats_lock:
                self.client_stats.fallback_fetches += 1
            return self._direct_fetch(demand)

    # ------------------------------------------------------------ byte paths
    def _require_backing(self) -> None:
        if self.backing is None:
            raise ValueError("byte fetch requested without a backing store")

    def _plan_ranges(self, file_path: PathT, offset: int, size: int,
                     out: ReadOutcome) -> List[Tuple[RangeRequest, bool]]:
        """Per-block exact sub-ranges covering the requested extent:
        ``[((block_path, start, length), hit), ...]`` in byte order.  The
        v2 ranged protocol means only the requested bytes move — no
        whole-block over-fetch on partial-extent reads."""
        bs = self.engine.cfg.block_size
        first = offset // bs
        # out.blocks carry populated block sizes (file tail may be short);
        # clamp the requested range to what the kernel actually served
        last_b = first + len(out.blocks) - 1
        end = min(offset + size, last_b * bs + out.blocks[-1].size)
        plan: List[Tuple[RangeRequest, bool]] = []
        for i, blk in enumerate(out.blocks):
            b = first + i
            start = max(offset, b * bs) - b * bs
            stop = min(end, b * bs + blk.size) - b * bs
            if stop > start:
                plan.append(((block_key(file_path, b), start, stop - start),
                             blk.hit))
        return plan

    def _fetch_hits(self, plans: List[List[Tuple[RangeRequest, bool]]],
                    fetched: Dict[RangeRequest, np.ndarray]) -> None:
        """Read the cache-hit ranges of every plan locally in **one**
        batched ``fetch_many`` (synthesized/served by the backing store —
        the repo carries no block payload store), deduped across plans
        and against already-demand-fetched ranges."""
        local: List[RangeRequest] = []
        for plan in plans:
            for r, hit in plan:
                if hit and r not in fetched:
                    fetched[r] = None  # type: ignore[assignment]  # dedup
                    local.append(r)
        if local:
            fetched.update(zip(local, self.executor.fetch_ranges(local)))

    def _assemble(self, plan: List[Tuple[RangeRequest, bool]],
                  fetched: Dict[RangeRequest, np.ndarray]) -> np.ndarray:
        """Stitch one extent together from the fetched range map."""
        chunks = [np.asarray(fetched[r], dtype=np.uint8) for r, _ in plan]
        if not chunks:
            return np.empty(0, dtype=np.uint8)
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    # ------------------------------------------------------ kernel passthrough
    def complete_prefetch(self, path: PathT, size: int,
                          now: Optional[float] = None) -> bool:
        if now is None:
            now = self.clock()
        with self.guard.lock_for(path):
            return self.engine.complete_prefetch(path, size, now)

    def cancel_prefetch(self, path: PathT) -> None:
        with self.guard.lock_for(path):
            self.engine.cancel_prefetch(path)

    def tick(self, now: Optional[float] = None) -> None:
        if now is None:
            now = self.clock()
        self.guard.acquire_all()
        try:
            self.engine.tick(now)
        finally:
            self.guard.release_all()

    def pin(self, path: PathT) -> None:
        self.guard.acquire_all()
        try:
            self.engine.pin(path)
        finally:
            self.guard.release_all()

    def never_cache(self, path: PathT) -> None:
        self.guard.acquire_all()
        try:
            self.engine.never_cache(path)
        finally:
            self.guard.release_all()

    # ----------------------------------------------------------------- stats
    @property
    def meta(self):
        return self.engine.meta

    @property
    def cfg(self) -> CacheConfig:
        return self.engine.cfg

    @property
    def stats(self):
        return self.engine.stats

    def hit_ratio(self) -> float:
        return self.engine.hit_ratio()

    def store_capabilities(self):
        """Negotiated capabilities of the backing store (``None`` for a
        metadata-only client)."""
        if self.backing is None:
            return None
        caps = getattr(self.backing, "capabilities", None)
        if caps is None:
            from ..storage.api import StoreCapabilities
            return StoreCapabilities()
        return caps()

    def snapshot(self) -> dict:
        s = self.engine.snapshot()
        s["executor"] = self.executor.stats.snapshot()
        s["client"] = self.client_stats.snapshot()
        caps = self.store_capabilities()
        if caps is not None:
            s["store"] = {"capabilities": caps.snapshot()}
        if self.breaker is not None:
            s.setdefault("store", {})["breaker"] = self.breaker.snapshot()
        tiers = getattr(self.backing, "tier_stats", None)
        if callable(tiers):
            s.setdefault("store", {})["tiers"] = tiers()
        return s

    def fault_stats(self) -> dict:
        """Supervision observability of the underlying driver (shard
        states, restart budgets, kill/respawn events) plus this client's
        degraded-path counters.  In-process engines have no failure
        domains, so their driver section is empty."""
        fn = getattr(self.engine, "fault_stats", None)
        got = fn() if fn is not None else {"restarts": 0, "shards": {},
                                           "events": []}
        got["client"] = self.client_stats.snapshot()
        return got

    def shard_states(self) -> List[str]:
        fn = getattr(self.engine, "shard_states", None)
        if fn is not None:
            return fn()
        return [SHARD_UP] * getattr(self.engine, "n_shards", 1)

    def iter_workload_cmus(self):
        return self.engine.iter_workload_cmus()

    # ------------------------------------------------------------- lifecycle
    def set_executor(self, executor: PrefetchExecutor) -> None:
        """Swap the prefetch transport: the old executor is closed (its
        queued candidates cancelled on the kernel) and the new one is
        attached.  The cluster simulator uses this to re-route a client's
        prefetches onto its simulated link."""
        self.executor.close(cancel_pending=True)
        executor.attach(self.engine, self.backing, self.guard, self.clock,
                        self.retry)
        self.executor = executor

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until every in-flight prefetch completed (ThreadedExecutor;
        inline executors are always drained)."""
        return self.executor.flush(timeout)

    def close(self, cancel_pending: bool = True) -> None:
        """Shut the executor down (cancelling queued candidates on the
        kernel), then — when this client constructed its engine
        (``open_cache``) — the engine itself.  In-process kernels carry
        no OS resources; the multi-process driver joins its workers and
        releases the shared-memory arena."""
        if self._closed:
            return
        self._closed = True
        self.executor.close(cancel_pending=cancel_pending)
        if self._own_engine:
            engine_close = getattr(self.engine, "close", None)
            if engine_close is not None:
                engine_close()

    def __enter__(self) -> "CacheClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_EXECUTORS = ("sim", "threaded", "none", "process")


def open_cache(store, capacity: Optional[int] = None, *,
               cfg: Optional[CacheConfig] = None,
               options: Optional[EngineOptions] = None,
               n_shards: int = 1,
               driver: str = "thread",
               n_procs: Optional[int] = None,
               arena_bytes: Optional[int] = None,
               executor: Optional[Union[str, PrefetchExecutor]] = None,
               backing=None,
               clock: Optional[Callable[[], float]] = None,
               fetch_bytes: bool = False,
               retry=None,
               queue_depth: int = 4096,
               max_fetch_bytes: int = 4096,
               degraded: bool = True,
               breaker=None,
               supervise: bool = True,
               restart_budget: int = 3,
               restart_window_s: float = 60.0,
               heartbeat_s: Optional[float] = None,
               rpc_timeout_s: float = 30.0) -> CacheClient:
    """The one constructor path: store (instance or URI) + capacity →
    CacheClient.

    ``store`` is either a store object or a URI for the scheme registry
    (``"sim://default"``, ``"file:///data/dir"``, ``"mem://"``,
    ``"faulty+sim://default?fail_rate=0.1&seed=7"`` — see
    ``storage.api.open_store``).  It doubles as the kernel's
    ``StoreMeta`` and (unless ``backing`` overrides it) the client's
    backing store; legacy one-method ``fetch_block`` stores are adapted
    automatically.

    A ``cache://`` URI (or ``DaemonAddress``) is special: it names a
    running :class:`~repro.daemon.CacheDaemon`, so ``open_cache``
    returns a connected ``RemoteCacheClient`` session instead of
    building an engine — ``capacity`` must be omitted (the daemon owns
    engine configuration) and only ``fetch_bytes`` plus the URI's query
    params apply.

    ``driver`` selects where the shard kernels run:

    * ``"thread"`` (default) — in this process (``make_engine``:
      the plain ``IGTCache`` at ``n_shards=1``, the ``ShardedIGTCache``
      facade otherwise);
    * ``"process"`` — one worker process per shard
      (``core.procdriver.ProcessShardedCache``), ``n_procs`` of them
      (defaults to ``n_shards`` when that is > 1, else 2), with fetched
      bytes crossing through a shared-memory arena of ``arena_bytes``.

    ``executor`` picks the prefetch transport: ``"sim"`` (deterministic
    inline, virtual-clock callers), ``"threaded"`` (per-shard background
    workers, wall-clock callers), ``"none"`` (read-only: candidates
    cancelled), ``"process"`` (worker-resident fetch+complete — requires
    ``driver="process"``), or a pre-built :class:`PrefetchExecutor`
    instance.  When omitted it follows the driver: ``"sim"`` in-process,
    ``"process"`` for the process driver.  ``retry`` is the
    ``storage.api.RetryPolicy`` guarding every byte fetch.

    Fault tolerance (see docs/RELIABILITY.md): ``degraded`` keeps reads
    flowing around a dead shard (direct store fetches, counted in
    ``ClientStats``); ``breaker`` is an optional
    ``storage.api.CircuitBreaker`` guarding client-side fetches.  The
    remaining knobs configure the process driver's supervisor and are
    ignored by ``driver="thread"`` (in-process shards share this
    process's fate — there is nothing to supervise): ``supervise``
    (respawn dead shard workers), ``restart_budget`` restarts per
    ``restart_window_s`` seconds before a shard goes permanently down,
    ``heartbeat_s`` (liveness deadline for hung-worker detection, off by
    default), and ``rpc_timeout_s`` (per-RPC reply deadline; a breach
    kills and respawns the worker instead of hanging the caller).
    """
    if isinstance(store, str):
        from ..storage.api import open_store
        store = open_store(store)
    if getattr(store, "is_cache_address", False):
        # cache://<sock-or-host:port> — a running CacheDaemon endpoint:
        # the daemon already owns the engine (capacity, shards, driver,
        # executor), so the answer is a thin connected session, not a
        # locally constructed stack.  URI query params (?fetch_bytes=
        # true&label=trainer0) merge under explicit kwargs.
        from ..daemon.client import RemoteCacheClient
        if capacity is not None:
            raise ValueError(
                "capacity is owned by the daemon for cache:// stores — "
                "configure it where the CacheDaemon is constructed")
        params = dict(store.params)
        params.setdefault("fetch_bytes", fetch_bytes)
        allowed = ("fetch_bytes", "label", "heartbeat", "shm",
                   "connect_timeout", "reconnect", "degraded",
                   "max_backoff_s", "rpc_timeout_s")
        kw = {k: v for k, v in params.items() if k in allowed}
        if backing is not None:
            # degraded reads while the daemon is away need a local byte
            # path; a backing store (object or URI) provides it
            if isinstance(backing, str):
                from ..storage.api import open_store
                backing = open_store(backing)
            kw["backing"] = backing
        return RemoteCacheClient(store, **kw)
    if capacity is None:
        raise TypeError("open_cache() missing required argument: "
                        "'capacity' (only cache:// stores omit it)")
    if driver not in ("thread", "process"):
        raise ValueError(f"unknown driver {driver!r}; expected 'thread' "
                         f"or 'process'")
    if executor is None:
        executor = "process" if driver == "process" else "sim"
    if isinstance(executor, str) and executor not in _EXECUTORS:
        # validate BEFORE constructing the engine: a process-backed
        # engine spawns workers that must not leak over a typo
        raise ValueError(
            f"unknown executor {executor!r}; expected one of "
            f"{sorted(_EXECUTORS)} or a PrefetchExecutor instance")
    if driver == "process":
        from .procdriver import DEFAULT_ARENA_BYTES, ProcessShardedCache
        if n_procs is None:
            n_procs = n_shards if n_shards > 1 else 2
        engine: Engine = ProcessShardedCache(
            store, capacity, cfg=cfg, options=options, n_procs=n_procs,
            arena_bytes=(DEFAULT_ARENA_BYTES if arena_bytes is None
                         else arena_bytes),
            backing=backing,     # workers serve demand misses from it
            retry=retry,
            supervise=supervise, restart_budget=restart_budget,
            restart_window_s=restart_window_s, heartbeat_s=heartbeat_s,
            rpc_timeout_s=rpc_timeout_s)
    else:
        if n_procs is not None:
            raise ValueError("n_procs only applies to driver='process'")
        engine = make_engine(store, capacity, cfg=cfg, options=options,
                             n_shards=n_shards)
    if backing is None:
        backing = store          # normalized (or rejected) by CacheClient
    if isinstance(executor, str):
        if executor == "threaded":
            executor = ThreadedExecutor(queue_depth=queue_depth,
                                        max_fetch_bytes=max_fetch_bytes)
        elif executor == "process":
            from .procdriver import ProcessExecutor
            executor = ProcessExecutor(queue_depth=queue_depth,
                                       max_fetch_bytes=max_fetch_bytes)
        elif executor == "sim":
            executor = SimExecutor()
        else:
            executor = NullExecutor()
    try:
        client = CacheClient(engine, backing=backing, executor=executor,
                             clock=clock, fetch_bytes=fetch_bytes,
                             retry=retry, degraded=degraded,
                             breaker=breaker)
    except BaseException:
        engine_close = getattr(engine, "close", None)
        if engine_close is not None:     # never leak worker processes
            engine_close()
        raise
    client._own_engine = True
    return client
