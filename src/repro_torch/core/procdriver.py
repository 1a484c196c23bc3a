"""Multi-process shard driver: process-owned kernels + shared-memory arena.

The ``ShardedIGTCache`` facade made the engine N independent state
machines, and the ``ThreadedExecutor`` gave each shard its own worker —
but every shard still executes in one GIL-bound process, so 4 shards are
*slower* per access than 1 (BENCH_overhead.json ``sharded``).  This
module is the scaling lever: each shard kernel lives in
its **own worker process** (owning its AccessStreamTree, chain/ctx
caches, ``UnifiedCache`` partition — and its own store instance,
re-opened per process via ``storage.api.store_spec``), behind the same
engine API and the same ``CacheClient``.  Hoard (arXiv:1812.00669) uses
the same shape for distributed DL caches: per-worker cache daemons with a
thin client library in front.

Three pieces:

* :class:`ProcessShardedCache` — the driver/facade.  Routing and the
  cross-shard allocation rule are shared with the in-process facade
  (``sharded.ShardRouting`` / ``GlobalRebalancer.plan_moves``): commands
  travel as small batched tuples over one pipe per worker — **one
  round-trip per** ``read_batch`` **per shard** — and each rebalance
  round aggregates the workers' serialized per-CMU ``DemandSummary``
  rows, plans centrally with the same greedy max-B ← min-B rule, and
  ships quota/capacity deltas back (``adjust_capacity`` worker-side), so
  space allocation stays cluster-wide.
* :class:`ShmArena` — a ``multiprocessing.shared_memory`` block split
  into per-worker regions.  Workers write fetched bytes into arena slots
  and reply with ``(offset, length)`` descriptors; the client maps them
  as read-only ``memoryview``-backed arrays — **payload bytes never ride
  pickle**.  Slot lifecycle is refcounted on the client: when the last
  array view is garbage-collected, the slot offset is queued and
  piggybacked on the next command to that worker, which returns it to
  the region's free list.  If a region is exhausted the worker falls
  back to an inline reply (counted as a *spill* — visible in
  ``arena_spills()`` so benchmarks/tests can assert the zero-copy path).
* :class:`ProcessExecutor` — the ``PrefetchExecutor`` for this driver.
  Same contract as the ``ThreadedExecutor`` (tests/test_client.py
  semantics): bounded per-shard background queues with in-queue dedup,
  demand fetches as a strict-priority class, cancel-on-overflow /
  dedup / shutdown via ``cancel_prefetch`` **on the worker's kernel**
  (never a silent drop), so ``submitted == completed + cancelled +
  deduped`` holds at close and the worker-side pending tables never
  leak — even under a failing backend (worker-side retries on
  ``TransientStoreError``; permanent failures cancel the candidate).

Client-side, each worker pipe is **pipelined**: callers send commands
directly under a per-channel send lock (a ``read_batch`` has every
shard's sub-batch in flight before the first reply is awaited — that
concurrency is the speedup), and one receiver thread per channel
matches FIFO replies to in-flight commands.  Background candidates
coalesce into at most one in-flight ``prefetch_batch`` per channel
(bounded priority inversion for demand commands); read replies are
key-free compact tuples decoded lazily (:class:`WireOutcome`).  A dead
worker breaks its pipe, which fails that channel's pending commands
instead of hanging the caller.
"""
from __future__ import annotations

import bisect
import gc
import multiprocessing
import os
import threading
import time
import weakref
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from ..train.fault import Heartbeat
from .client import PrefetchExecutor, _sync_block_size
from .faults import (RestartBudget, SHARD_DOWN, SHARD_RESTARTING, SHARD_UP,
                     ShardUnavailableError)
from .igtcache import EngineOptions, IGTCache, ReadOutcome
from .meta import StoreMeta
from .sharded import (DemandSummary, GlobalRebalancer, ShardDemandTracker,
                      ShardRouting, ShardSummary, split_capacity)
from .types import CacheConfig, CacheStats, MB, PathT, Pattern
# the compact reply codec is shared with the network cache daemon
# (repro_torch.daemon speaks the same frames) — core/wire.py is the one
# definition; the old procdriver names stay importable from here
from .wire import WireOutcome, encode_outcome as _encode_out

__all__ = ["ProcessExecutor", "ProcessShardedCache", "ShmArena",
           "WireOutcome"]

_UNSET = object()          # sentinel: "use the driver's default rpc timeout"

DEFAULT_ARENA_BYTES = 64 * MB
# background candidates coalesced into one prefetch_batch command
PREFETCH_COALESCE = 64


# ---------------------------------------------------------------------------
# shared-memory byte arena
# ---------------------------------------------------------------------------

class _RegionAllocator:
    """First-fit free-list allocator over one worker's arena region
    (worker-side; offsets are absolute within the shared block).  Frees
    arrive as piggybacked ``(offset, length)`` pairs on later commands
    and coalesce with adjacent free intervals."""

    def __init__(self, offset: int, length: int,
                 reserved: Sequence[Tuple[int, int]] = ()) -> None:
        self._free: List[Tuple[int, int]] = ([(offset, length)]
                                             if length > 0 else [])
        # respawn path: slots the *previous* worker generation handed to
        # the client as live arena views are carved out up front, so the
        # fresh allocator can never hand them to new fetches while the
        # client still reads them; the client's piggybacked frees return
        # them to the pool as the old views are collected.
        for off, n in sorted(reserved):
            self.reserve(off, n)

    def reserve(self, offset: int, n: int) -> bool:
        """Remove ``[offset, offset+n)`` from the free list (must lie
        inside one free interval — true for slots the previous
        generation allocated from the same region)."""
        if n <= 0:
            return True
        for i, (off, length) in enumerate(self._free):
            if off <= offset and offset + n <= off + length:
                pieces = []
                if offset > off:
                    pieces.append((off, offset - off))
                tail = (off + length) - (offset + n)
                if tail > 0:
                    pieces.append((offset + n, tail))
                self._free[i:i + 1] = pieces
                return True
        return False

    def alloc(self, n: int) -> int:
        """Absolute offset of an ``n``-byte slot, or -1 when exhausted."""
        if n <= 0:
            return -1
        for i, (off, length) in enumerate(self._free):
            if length >= n:
                if length == n:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + n, length - n)
                return off
        return -1

    def free(self, offset: int, n: int) -> None:
        if n <= 0:
            return
        i = bisect.bisect_left(self._free, (offset, n))
        self._free.insert(i, (offset, n))
        # coalesce with right then left neighbour
        if i + 1 < len(self._free):
            off, length = self._free[i]
            noff, nlen = self._free[i + 1]
            if off + length == noff:
                self._free[i] = (off, length + nlen)
                self._free.pop(i + 1)
        if i > 0:
            poff, plen = self._free[i - 1]
            off, length = self._free[i]
            if poff + plen == off:
                self._free[i - 1] = (poff, plen + length)
                self._free.pop(i)

    def free_bytes(self) -> int:
        return sum(length for _, length in self._free)


class ShmArena:
    """One ``multiprocessing.shared_memory`` block, split into equal
    per-worker regions so workers allocate without any cross-process
    locking (each region has exactly one writer: its worker).  The
    client (creator) maps reply descriptors as read-only numpy views;
    ``view()`` attaches a finalizer that queues the slot for reuse when
    the last reference dies."""

    def __init__(self, total_bytes: int, n_regions: int) -> None:
        from multiprocessing import shared_memory
        region = max(0, total_bytes) // max(1, n_regions)
        self.region_bytes = region
        self.shm = (shared_memory.SharedMemory(create=True,
                                               size=region * n_regions)
                    if region > 0 else None)
        self.name = self.shm.name if self.shm is not None else None
        self._closed = False

    def region(self, i: int) -> Tuple[int, int]:
        return i * self.region_bytes, self.region_bytes

    def view(self, offset: int, length: int,
             on_release: Optional[Callable[[int, int], None]] = None
             ) -> np.ndarray:
        """Read-only zero-copy array over ``[offset, offset+length)``.
        ``on_release(offset, length)`` fires when the array (and
        everything sharing its buffer) is garbage-collected."""
        if length == 0 or self.shm is None:
            return np.empty(0, dtype=np.uint8)
        arr = np.frombuffer(self.shm.buf, dtype=np.uint8, count=length,
                            offset=offset)
        arr.flags.writeable = False
        if on_release is not None:
            weakref.finalize(arr, on_release, offset, length)
        return arr

    def close(self) -> None:
        if self._closed or self.shm is None:
            return
        self._closed = True
        try:
            self.shm.close()
        except BufferError:
            # client still holds live views into the block: the mapping
            # can only drop when they are collected.  Silence the
            # destructor's doomed re-close (it would print an ignored
            # BufferError at interpreter exit) — the OS reclaims the
            # mapping with the process either way.
            self.shm.close = lambda: None
        try:
            self.shm.unlink()
        except FileNotFoundError:  # pragma: no cover - double unlink
            pass


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

class _WorkerState:
    """Everything one shard worker owns: its kernel, its store, its
    arena region, its demand tracker."""

    def __init__(self, sid, kernel, store, backing, retry, shm, alloc):
        self.sid = sid
        self.kernel = kernel
        self.store = store
        self.backing = backing
        self.retry = retry
        self.shm = shm
        self.alloc = alloc
        self.tracker = ShardDemandTracker(kernel.cfg)
        self.spills = 0
        self.retries = 0
        # unpickled path tuples are fresh objects every command: no
        # cached hashes, no identity fast-path in the kernel's many
        # per-access dict hops.  Canonicalize to the first-seen tuple —
        # one lookup here buys identity-hit lookups everywhere below.
        # Bounded like the kernel's own memo caches: a worker streaming
        # over millions of distinct blocks must not retain every tuple
        # forever; on overflow the map simply resets (correctness is
        # unaffected — canonicalization is a pure perf identity map).
        self._canon: Dict[PathT, PathT] = {}

    _CANON_MAX = 1 << 20

    def canon(self, path: PathT) -> PathT:
        got = self._canon.get(path)
        if got is None:
            if len(self._canon) >= self._CANON_MAX:
                self._canon.clear()
            self._canon[path] = path
            got = path
        return got

    def note_retry(self, attempt, exc) -> None:
        self.retries += 1


def _worker_main(conn, shm_name: Optional[str], region: Tuple[int, int],
                 spec, backing_spec, capacity: int,
                 cfg: Optional[CacheConfig],
                 options: Optional[EngineOptions], sid: int,
                 retry, pause_gc: bool,
                 reserved: Sequence[Tuple[int, int]] = ()) -> None:
    """Shard worker entry point: build the kernel + per-process store,
    then serve commands until ``stop``/EOF.  Every inbound message is
    ``(op, frees, payload)`` — ``frees`` returns arena slots the client
    released; every reply is ``("ok", result)`` or ``("err", exc)``.

    A worker never touches CUDA.  Under ``fork`` it inherits the parent's
    heap, which in a trainer or a server holds CUDA tensors, streams and
    events; a forked child must not call into the CUDA driver, and freeing
    one of those objects would.  So every inherited object moves to the
    collector's permanent generation before the worker allocates anything:
    the child's cyclic collections (or the ``pause_gc`` switch) never reach
    them, and the worker's own code holds no reference it could drop.  The
    worker ends in ``os._exit`` (multiprocessing's fork child), so no
    interpreter finalizer runs on the inherited heap either."""
    gc.freeze()
    from ..storage.api import RetryPolicy, as_backing_store, resolve_store_spec
    store = resolve_store_spec(spec)
    cfg = cfg or CacheConfig()
    _sync_block_size(store, cfg)     # worker instance must agree on geometry
    kernel = IGTCache(store, capacity, cfg=cfg, options=options)
    # byte fetches may come from a different store than the metadata
    # (the client's `backing` override travels as its own spec)
    if backing_spec is None:
        backing_store = store
    else:
        backing_store = resolve_store_spec(backing_spec)
        _sync_block_size(backing_store, cfg)
    shm = None
    if shm_name is not None and region[1] > 0:
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=shm_name)
    state = _WorkerState(sid, kernel, store, as_backing_store(backing_store),
                         retry if retry is not None else RetryPolicy(),
                         shm, _RegionAllocator(*region, reserved=reserved))
    if pause_gc:
        gc.disable()
    try:
        _serve(conn, state)
    finally:
        if shm is not None:
            try:
                shm.close()
            except BufferError:  # pragma: no cover
                pass
        conn.close()


def _serve(conn, state: _WorkerState) -> None:
    kernel = state.kernel
    while True:
        try:
            op, frees, payload = conn.recv()
        except (EOFError, OSError):
            return
        for off, n in frees:
            state.alloc.free(off, n)
        try:
            result = _dispatch(state, kernel, op, payload)
        except BaseException as e:
            try:
                conn.send(("err", e))
            except Exception:    # unpicklable exception: degrade to repr
                conn.send(("err", RuntimeError(repr(e))))
            continue
        conn.send(("ok", result))
        if op == "stop":
            return


def _dispatch(state: _WorkerState, kernel: IGTCache, op: str, payload):
    bs = kernel.cfg.block_size
    if op == "read_batch":
        reqs, now, inline = payload
        canon = state.canon
        outs = kernel.read_batch([(canon(fp), off, sz)
                                  for fp, off, sz in reqs], now)
        done = _inline_complete(kernel, outs, now) if inline else 0
        return [_encode_out(o, req[1] // bs)
                for o, req in zip(outs, reqs)], done
    if op == "read":
        fp, off, size, now, inline = payload
        out = kernel.read(state.canon(fp), off, size, now)
        done = _inline_complete(kernel, [out], now) if inline else 0
        return _encode_out(out, off // bs), done
    if op == "read_serial":
        fp, off, size, now, inline = payload
        out = kernel.read_serial(state.canon(fp), off, size, now)
        done = _inline_complete(kernel, [out], now) if inline else 0
        return _encode_out(out, off // bs), done
    if op == "fetch":
        return _op_fetch(state, payload)
    if op == "prefetch_batch":
        return _op_prefetch_batch(state, *payload)
    if op == "cancel_many":
        for path in payload:
            kernel.cancel_prefetch(state.canon(path))
        return len(payload)
    if op == "complete":
        path, size, now = payload
        return kernel.complete_prefetch(state.canon(path), size, now)
    if op == "cancel":
        kernel.cancel_prefetch(state.canon(payload))
        return None
    if op == "tick":
        kernel.tick(payload)
        return None
    if op == "rebalance_summary":
        # summarize() builds the bounded wire ShardSummary (exact rows
        # for the default + top-k CMUs, sketch payloads for the block
        # heat) as a side effect — ship that, not the raw row list
        state.tracker.summarize(kernel, state.sid, payload)
        return state.tracker.summaries[state.sid]
    if op == "rebalance_apply":
        return _op_apply_alloc(kernel, *payload)
    if op == "stats":
        return {"stats": kernel.stats,
                "nodes": kernel.tree.node_count(),
                "used": kernel.cache.used_bytes(),
                "capacity": kernel.cache.capacity,
                "cmus": len(kernel.cache.cmus) - 1,
                "pending": len(kernel._pending_prefetch),
                "spills": state.spills,
                "arena_free": state.alloc.free_bytes()}
    if op == "snapshot":
        return kernel.snapshot()
    if op == "cmus":
        return [(path, c.effective_pattern().value, c.quota, c.used,
                 c.hits, c.misses)
                for path, c in kernel.iter_workload_cmus()]
    if op == "pin":
        kernel.pin(payload)
        return None
    if op == "never_cache":
        kernel.never_cache(payload)
        return None
    if op == "invalidate_meta":
        # the documented mid-run refresh workflow (storage/local_fs.py):
        # each worker owns its store instance, so the re-walk must
        # happen HERE — a client-side store.refresh() never reaches the
        # workers' snapshots
        for obj in {id(state.store): state.store,
                    id(state.backing): state.backing}.values():
            refresh = getattr(obj, "refresh", None)
            if callable(refresh):
                refresh()
        kernel.invalidate_meta_cache()
        return None
    if op == "debug_pending":
        return set(kernel._pending_prefetch)
    if op == "hello":
        caps = getattr(state.backing, "capabilities", None)
        return {"pid": os.getpid(),
                "capabilities": caps().snapshot() if caps else None}
    if op == "stop":
        return None
    raise ValueError(f"unknown worker op {op!r}")


def _inline_complete(kernel: IGTCache, outs: Sequence[ReadOutcome],
                     now: float) -> int:
    """Worker-side inline prefetch completion (``prefetch="inline"``):
    the exact protocol of the caller-driven kernel loop — every candidate
    completes at the read's own ``now``, kernel-side, no byte movement.
    Completed candidates are stripped from the outcome so the client
    cannot double-dispatch them."""
    done = 0
    for out in outs:
        if out.prefetches:
            for p, s in out.prefetches:
                kernel.complete_prefetch(p, s, now)
            done += len(out.prefetches)
            out.prefetches = []
    return done


def _op_fetch(state: _WorkerState, requests):
    """Demand fetch into the arena: one ``fetch_many`` against this
    worker's own store, results written into region slots, descriptors
    (not bytes) back over the pipe.  Transient errors retried here (the
    retry count travels in the reply); a permanent error fails the batch
    like a real multi-range response with a failed part."""
    before = state.retries
    datas = state.retry.call(state.backing.fetch_many, list(requests),
                             on_retry=state.note_retry)
    entries: List[tuple] = []
    for d in datas:
        d = np.asarray(d, dtype=np.uint8)
        n = int(d.size)
        off = state.alloc.alloc(n) if state.shm is not None else -1
        if n == 0:
            entries.append(("shm", 0, 0))
        elif off < 0:
            state.spills += 1          # region exhausted: inline fallback
            entries.append(("raw", d))
        else:
            dst = np.frombuffer(state.shm.buf, dtype=np.uint8, count=n,
                                offset=off)
            dst[:] = d
            entries.append(("shm", off, n))
    return entries, state.retries - before


def _op_prefetch_batch(state: _WorkerState, cands, now: float,
                       max_fetch_bytes: int):
    """One coalesced batch of background candidates: capped byte fetch
    (retry-guarded) + ``complete_prefetch`` on this worker's kernel; a
    fetch that fails past the retry bound cancels the candidate instead
    — the executor identity survives a failing backend."""
    kernel = state.kernel
    completed = cancelled = errors = 0
    before = state.retries
    for path, size in cands:
        path = state.canon(path)
        try:
            if state.backing is not None and max_fetch_bytes > 0:
                state.retry.call(state.backing.fetch_range, path, 0,
                                 min(size, max_fetch_bytes),
                                 on_retry=state.note_retry)
            kernel.complete_prefetch(path, size, now)
            completed += 1
        except Exception:
            errors += 1
            kernel.cancel_prefetch(path)
            cancelled += 1
    return completed, cancelled, state.retries - before, errors


def _op_apply_alloc(kernel: IGTCache, shrinks, cap_delta: int, grows):
    """Apply one rebalance round's deltas: quota shrinks first (forced
    eviction happens while the capacity is still here), then the pool
    capacity delta, then quota grows — ``sum(quota) == capacity`` holds
    when the command completes.  A CMU removed (TTL) between summary and
    apply falls back to the default CMU so the invariant survives."""
    cache = kernel.cache

    def adj(key, delta):
        cmu = cache.cmus.get(tuple(key))
        if cmu is None:
            cmu = cache.default_cmu
        cmu.set_quota(cmu.quota + delta)

    for key, amt in shrinks:
        adj(key, -amt)
    if cap_delta:
        cache.adjust_capacity(cap_delta)
    for key, amt in grows:
        adj(key, amt)
    return None


# ---------------------------------------------------------------------------
# client side: per-shard channel + dispatcher
# ---------------------------------------------------------------------------

class _RPC:
    """One demand-class command awaiting its reply."""

    __slots__ = ("op", "payload", "event", "reply", "error")

    def __init__(self, op: str, payload) -> None:
        self.op = op
        self.payload = payload
        self.event = threading.Event()
        self.reply = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None):
        if not self.event.wait(timeout):
            raise TimeoutError(f"worker RPC {self.op!r} timed out")
        if self.error is not None:
            raise self.error
        return self.reply


class _PrefetchBatch:
    """Marker for one in-flight coalesced ``prefetch_batch`` command."""

    __slots__ = ("items",)

    def __init__(self, items) -> None:
        self.items = items


class _ShardChannel:
    """Client-side endpoint for one worker pipe, **pipelined**: callers
    send commands directly (no dispatcher hop) under ``send_lock``,
    appending an :class:`_RPC` to the FIFO ``pending`` deque; the
    worker serves strictly in order, so the channel's single receiver
    thread matches each reply to ``pending.popleft()``.  Multiple
    commands can be in flight at once — a ``read_batch`` fans out to
    every shard before the first reply is awaited, which is what makes
    the workers compute in parallel.

    Background prefetch candidates queue separately (bounded, deduped)
    and at most **one** coalesced ``prefetch_batch`` command is in
    flight per channel, so a demand command never waits behind more
    than one bounded batch of capped background fetches — the process
    driver's version of the ThreadedExecutor's demand>prefetch
    priority.  Pending arena frees piggyback on the next outbound
    command."""

    def __init__(self, sid: int, conn, proc, capacity: int = 0,
                 budget: Optional[RestartBudget] = None) -> None:
        self.sid = sid
        self.conn = conn
        self.proc = proc
        self.send_lock = threading.Lock()
        self.pending: Deque[object] = deque()     # _RPC | _PrefetchBatch
        self.cv = threading.Condition()           # background bookkeeping
        # (path, size, key, now)
        self.background: Deque[Tuple[PathT, int, str, float]] = deque()
        self.keys: Set[str] = set()        # queued + in-flight candidates
        self.outstanding = 0               # background items not yet done
        self.batch_inflight = False
        self.pending_frees: List[Tuple[int, int]] = []
        self.closed = False                # no new sends accepted
        # -- fault-tolerance state (supervisor-owned transitions) -----------
        self.state = SHARD_UP              # up | restarting | down
        self.generation = 0                # bumped on every respawn
        self.capacity = capacity           # client-tracked (frozen on death)
        self.budget = budget or RestartBudget()
        self.live: Dict[int, int] = {}     # arena slots with client views
        self.last_stats: Optional[dict] = None   # last good "stats" reply
        self.stats_carry = CacheStats()    # counters from dead generations
        self.recv_thread: Optional[threading.Thread] = None
        self.died_at = 0.0                 # monotonic time of last death

    # -- outbound ------------------------------------------------------------
    def send_rpc(self, rpc: _RPC) -> bool:
        with self.send_lock:
            if self.closed:
                return False
            self.pending.append(rpc)
            try:
                self.conn.send((rpc.op, self.take_frees(), rpc.payload))
            except (OSError, ValueError, BrokenPipeError):
                self.pending.pop()         # ours: nothing was sent
                return False
            return True

    def send_batch(self, batch: _PrefetchBatch, payload) -> bool:
        with self.send_lock:
            if self.closed:
                return False
            self.pending.append(batch)
            try:
                self.conn.send(("prefetch_batch", self.take_frees(),
                                payload))
            except (OSError, ValueError, BrokenPipeError):
                self.pending.pop()
                return False
            return True

    # -- background queue ----------------------------------------------------
    def offer_background(self, path: PathT, size: int, key: str,
                         now: float, depth: int) -> str:
        """'queued' | 'dup' | 'full' | 'closed' (same verdicts as the
        ThreadedExecutor's shard queue)."""
        with self.cv:
            if self.closed:
                return "closed"
            if key in self.keys:
                return "dup"
            if len(self.background) >= depth:
                return "full"
            self.keys.add(key)
            self.background.append((path, size, key, now))
            self.outstanding += 1
            return "queued"

    def pop_batch(self) -> Optional[List[Tuple[PathT, int, str, float]]]:
        """Claim the next coalesced batch (None if one is already in
        flight or nothing is queued).  The claimer must send it and, on
        send failure, call :meth:`batch_done`."""
        with self.cv:
            if self.batch_inflight or not self.background:
                return None
            self.batch_inflight = True
            items = []
            while self.background and len(items) < PREFETCH_COALESCE:
                items.append(self.background.popleft())
            return items

    def batch_done(self, items) -> None:
        with self.cv:
            self.batch_inflight = False
            for _, _, key, _ in items:
                self.keys.discard(key)
            self.outstanding -= len(items)
            self.cv.notify_all()

    def drain_background(self) -> List[Tuple[PathT, int, str, float]]:
        with self.cv:
            items = list(self.background)
            self.background.clear()
            for _, _, key, _ in items:
                self.keys.discard(key)
            self.outstanding -= len(items)
            self.cv.notify_all()
            return items

    # -- arena frees ---------------------------------------------------------
    def note_live(self, offset: int, length: int) -> None:
        """An arena slot descriptor reached the client: until its views
        are collected, a respawned worker must treat it as reserved."""
        if length > 0:
            with self.cv:
                self.live[offset] = length

    def queue_free(self, offset: int, length: int) -> None:
        """Arena slot released client-side (last view collected): queue
        it for the worker's allocator, shipped with the next command.
        While the shard is RESTARTING the free still queues — the next
        generation's allocator has the slot carved out as reserved and
        this free is what eventually returns it to the pool."""
        with self.cv:
            self.live.pop(offset, None)
            if not self.closed or self.state == SHARD_RESTARTING:
                self.pending_frees.append((offset, length))

    def take_frees(self) -> List[Tuple[int, int]]:
        with self.cv:
            frees = self.pending_frees
            self.pending_frees = []
            return frees

    def begin_respawn(self) -> List[Tuple[int, int]]:
        """Atomic hand-off point for a respawn: returns the live-slot
        snapshot the new worker must reserve and drops frees queued for
        the *old* allocator (their slots are not in the snapshot, so the
        new allocator already considers them free — shipping them would
        double-free).  Frees queued after this call are for reserved
        slots and ship normally."""
        with self.cv:
            self.pending_frees = []
            return list(self.live.items())

    def wait_idle(self, timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cv:
            while self.outstanding > 0:
                if self.closed:
                    # dead channel: its queued work has been drained /
                    # failed — report the truth promptly instead of
                    # sleeping out the caller's full timeout
                    return False
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    return False
                self.cv.wait(rem if rem is not None else 0.1)
        return True


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

class ProcessShardedCache(ShardRouting):
    """Process-backed shard driver behind the engine's public API.

    Same surface as ``ShardedIGTCache`` — ``read`` / ``read_batch`` /
    ``read_serial`` / ``complete_prefetch`` / ``cancel_prefetch`` /
    ``pin`` / ``never_cache`` / ``tick`` / ``stats`` / ``hit_ratio`` /
    ``snapshot`` — with each shard kernel running in its own worker
    process.  ``read_batch`` splits the batch by shard, sends every
    sub-batch before waiting (one round-trip per shard, the sub-batches
    execute **in parallel** across workers), and reassembles outcomes in
    request order.

    ``prefetch`` selects the candidate protocol: ``"client"`` (default)
    returns candidates in the outcomes for a ``PrefetchExecutor`` to
    run; ``"inline"`` completes them worker-side at the read's own
    ``now`` — the exact kernel-loop protocol benchmarks compare against.

    ``store`` may be a URI (each worker re-opens it — per-process file
    handles and capability negotiation) or a store instance (shipped via
    ``storage.api.store_spec``; under the default ``fork`` start method
    the child inherits it, under ``spawn`` it must pickle).
    """

    def __init__(self, store, capacity: int, *,
                 cfg: Optional[CacheConfig] = None,
                 options: Optional[EngineOptions] = None,
                 n_procs: int = 2,
                 arena_bytes: int = DEFAULT_ARENA_BYTES,
                 prefetch: str = "client",
                 backing=None,
                 start_method: Optional[str] = None,
                 retry=None,
                 pause_worker_gc: bool = False,
                 supervise: bool = True,
                 restart_budget: int = 3,
                 restart_window_s: float = 60.0,
                 heartbeat_s: Optional[float] = None,
                 rpc_timeout_s: Optional[float] = 30.0) -> None:
        if prefetch not in ("client", "inline"):
            raise ValueError(f"prefetch must be 'client' or 'inline', "
                             f"got {prefetch!r}")
        self._init_routing(n_procs)
        from ..storage.api import store_spec
        if isinstance(store, str):
            from ..storage.api import open_store
            spec = ("uri", store)
            store = open_store(store)
        else:
            spec = store_spec(store)
        # `backing` overrides where the workers fetch *bytes* from (the
        # store stays the kernel's metadata source) — mirrors the
        # CacheClient knob so a process-driver client fetches hits and
        # misses from the same source
        backing_spec = (None if backing is None or backing is store
                        else store_spec(backing))
        self.meta: StoreMeta = store
        self.cfg = cfg or CacheConfig()
        _sync_block_size(store, self.cfg)
        self.options = options or EngineOptions()
        self.capacity = capacity
        self.prefetch_mode = prefetch
        self.global_rebalancer = GlobalRebalancer(self.cfg)
        self._inline = prefetch == "inline"
        self._executor: Optional["ProcessExecutor"] = None
        self._executor_lock = threading.Lock()
        self._closed = False
        self._lock = threading.Lock()
        self.supervise = supervise
        self.rpc_timeout_s = rpc_timeout_s
        self.heartbeat_s = heartbeat_s
        self._hb = Heartbeat(deadline_s=heartbeat_s or 0.0)
        # replayed to a respawned worker (its kernel comes back cold)
        self._pin_log: List[PathT] = []
        self._never_log: List[PathT] = []
        self.fault_events: List[dict] = []
        self._respawn_q: Deque[_ShardChannel] = deque()
        self._respawn_cv = threading.Condition()

        if start_method is None:
            start_method = ("fork" if "fork"
                            in multiprocessing.get_all_start_methods()
                            else "spawn")
        ctx = multiprocessing.get_context(start_method)
        # everything a respawn needs to rebuild a worker cold
        self._spawn = dict(ctx=ctx, spec=spec, backing_spec=backing_spec,
                           retry=retry, pause_gc=pause_worker_gc)
        self.arena = ShmArena(arena_bytes, n_procs)
        self._channels: List[_ShardChannel] = []
        caps = split_capacity(capacity, n_procs)
        # spawn every worker BEFORE starting any dispatcher thread (a
        # fork of a multi-threaded parent is where fork goes wrong).
        # Each child end is closed IMMEDIATELY after its start: a later
        # fork must not inherit an earlier pipe's child end, or killing
        # that earlier worker never EOFs its pipe (the dup keeps the
        # write side open) and the death goes undetected.
        for sid in range(n_procs):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_worker_main,
                args=(child, self.arena.name, self.arena.region(sid), spec,
                      backing_spec, caps[sid], self.cfg, self.options, sid,
                      retry, pause_worker_gc),
                name=f"igt-shard-{sid}", daemon=True)
            proc.start()
            child.close()                 # parent keeps only its end
            self._channels.append(_ShardChannel(
                sid, parent, proc, capacity=caps[sid],
                budget=RestartBudget(restart_budget, restart_window_s)))
        self._threads = []
        for ch in self._channels:
            t = threading.Thread(target=self._receive, args=(ch,),
                                 name=f"igt-chan-{ch.sid}", daemon=True)
            ch.recv_thread = t
            t.start()
            self._threads.append(t)
        self._supervisor: Optional[threading.Thread] = None
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervise_loop, name="igt-supervisor",
                daemon=True)
            self._supervisor.start()
        # pass the channel list (not a proc snapshot): respawns swap
        # ch.proc, and the safety net must kill the *current* generation
        self._finalizer = weakref.finalize(self, _cleanup_leftovers,
                                           self.arena, self._channels)
        # capability re-negotiation: each worker reports what *its* store
        # instance can do (a URI re-open may differ from the client's)
        self.worker_info = [self._rpc(sid, "hello", None)
                            for sid in range(n_procs)]

    # -------------------------------------------------------------- receiver
    def _receive(self, ch: _ShardChannel) -> None:
        """The channel's single reply consumer: blocks in ``recv`` (no
        polling, no notify ping-pong), matches each reply to the FIFO
        of in-flight commands.  One thread per channel so the byte
        reads and reply unpickling of different shards overlap (recv
        releases the GIL while reading the pipe).  A worker death (or a
        deliberate close) breaks the pipe, which wakes this thread to
        fail everything still pending instead of letting callers
        hang."""
        stopped = False
        beat = self.heartbeat_s is not None
        try:
            while True:
                try:
                    status, result = ch.conn.recv()
                except (EOFError, OSError):
                    break
                if beat:
                    self._hb.beat(ch.sid, time.monotonic())
                item = ch.pending.popleft()
                if isinstance(item, _PrefetchBatch):
                    self._on_batch_reply(ch, item, status, result)
                    self._pump_prefetch(ch)
                    continue
                if status == "ok" and item.op == "fetch":
                    # register live arena slots HERE, before the caller
                    # can even see the descriptors: if the worker dies
                    # and respawns, the new allocator must already treat
                    # them as reserved
                    for entry in result[0]:
                        if entry[0] == "shm":
                            ch.note_live(entry[1], entry[2])
                if status == "err":
                    item.error = result
                else:
                    item.reply = result
                item.event.set()
                if item.op == "stop":
                    stopped = True
                    break
        finally:
            # even on an unexpected receiver error (protocol bug,
            # unpicklable reply), no caller may be left hanging
            self._fail_channel(ch, graceful=stopped)

    def _fail_channel(self, ch: _ShardChannel, graceful: bool) -> None:
        with ch.send_lock:
            ch.closed = True
            if not graceful and ch.state == SHARD_UP:
                ch.state = SHARD_RESTARTING
        ch.died_at = time.monotonic()
        err = None if graceful else ShardUnavailableError(
            f"shard worker {ch.sid} died (exit code {ch.proc.exitcode}) "
            f"with commands in flight", sid=ch.sid, state=ch.state)
        while ch.pending:
            item = ch.pending.popleft()
            if isinstance(item, _PrefetchBatch):
                self._on_batch_reply(ch, item, "err", None)
                continue
            item.error = err or RuntimeError(
                "ProcessShardedCache channel closed with the RPC in flight")
            item.event.set()
        # queued-but-never-sent candidates: account as cancelled so the
        # executor identity still balances (the kernel died with its
        # pending table, there is nothing left to leak).  The executor
        # pointer is read under the registration lock so a concurrent
        # ProcessExecutor.close cannot detach between the read and the
        # accounting (the death-during-close stats race).
        drained = ch.drain_background()
        with self._executor_lock:
            sink = self._executor
            if drained and sink is not None:
                with sink._stats_lock:
                    sink.stats.cancelled += len(drained)
        if not graceful:
            # the dead kernel's counters survive as carried history so
            # the merged driver stats stay (approximately) monotone
            # across respawns — the delta since the last stats RPC is
            # lost with the process
            if ch.last_stats is not None:
                ch.stats_carry = CacheStats.merged(
                    [ch.stats_carry, ch.last_stats["stats"]])
                ch.last_stats = None
            if self.supervise and not self._closed \
                    and ch.state == SHARD_RESTARTING:
                with self._respawn_cv:
                    self._respawn_q.append(ch)
                    self._respawn_cv.notify_all()

    def _on_batch_reply(self, ch: _ShardChannel, batch: _PrefetchBatch,
                        status: str, result) -> None:
        if status == "ok":
            completed, cancelled, retries, errors = result
        else:
            # worker unreachable / errored: its kernel is gone with its
            # pending table — account the batch as cancelled so the
            # executor identity still balances
            completed, retries = 0, 0
            cancelled = errors = len(batch.items)
        with self._executor_lock:
            sink = self._executor
            if sink is not None:
                with sink._stats_lock:
                    sink.stats.completed += completed
                    sink.stats.cancelled += cancelled
                    sink.stats.retries += retries
                    sink.stats.fetch_errors += errors
        ch.batch_done(batch.items)

    def _pump_prefetch(self, ch: _ShardChannel) -> None:
        """Launch the next coalesced prefetch batch if none is in
        flight.  Called after an offer (kick-start) and after each batch
        reply (drain)."""
        items = ch.pop_batch()
        if not items:
            return
        with self._executor_lock:
            sink = self._executor
        cap = sink.max_fetch_bytes if sink is not None else 0
        batch = _PrefetchBatch(items)
        payload = ([(p, s) for p, s, _, _ in items], items[-1][3], cap)
        if not ch.send_batch(batch, payload):
            self._on_batch_reply(ch, batch, "err", None)

    # ------------------------------------------------------------------ RPC
    def _rpc_async(self, sid: int, op: str, payload) -> _RPC:
        ch = self._channels[sid]
        rpc = _RPC(op, payload)
        if not ch.send_rpc(rpc):
            if self._closed:
                rpc.error = RuntimeError(
                    f"{op!r} on a closed ProcessShardedCache")
            else:
                rpc.error = ShardUnavailableError(
                    f"shard {sid} is {ch.state} ({op!r} rejected)",
                    sid=sid, state=ch.state)
            rpc.event.set()
        elif self.heartbeat_s is not None:
            self._hb.beat(sid, time.monotonic())
        return rpc

    def _wait_rpc(self, sid: int, rpc: _RPC, timeout=_UNSET):
        """Bounded wait: a worker that neither replies nor dies within
        the RPC timeout is treated as hung — it is killed (SIGKILL works
        on a SIGSTOPped process too), which breaks the pipe and routes
        it through the normal death → supervision path — and the caller
        gets a typed ``ShardUnavailableError`` instead of blocking
        forever."""
        t = self.rpc_timeout_s if timeout is _UNSET else timeout
        try:
            return rpc.wait(t)
        except TimeoutError:
            self._kill_worker(sid, f"RPC {rpc.op!r} exceeded {t}s")
            raise ShardUnavailableError(
                f"shard {sid} RPC {rpc.op!r} timed out after {t}s",
                sid=sid, state=self._channels[sid].state) from None

    def _kill_worker(self, sid: int, reason: str) -> None:
        ch = self._channels[sid]
        proc = ch.proc
        if proc.is_alive():
            kill = getattr(proc, "kill", proc.terminate)
            kill()
        self.fault_events.append({"sid": sid, "kind": "kill",
                                  "reason": reason,
                                  "at": time.monotonic(),
                                  "generation": ch.generation})

    def _rpc(self, sid: int, op: str, payload, timeout=_UNSET):
        return self._wait_rpc(sid, self._rpc_async(sid, op, payload),
                              timeout)

    def _broadcast(self, op: str, payload, timeout=_UNSET,
                   tolerant: bool = False) -> list:
        """Fan an RPC to all shards.  ``tolerant`` skips shards that are
        not UP and swallows per-shard unavailability (used for controls
        and maintenance, which a down shard must not poison)."""
        sids = [sid for sid in range(self.n_shards)
                if not tolerant or self._channels[sid].state == SHARD_UP]
        rpcs = [(sid, self._rpc_async(sid, op, payload)) for sid in sids]
        out = []
        for sid, r in rpcs:
            try:
                out.append(self._wait_rpc(sid, r, timeout))
            except ShardUnavailableError:
                if not tolerant:
                    raise
        return out

    # ------------------------------------------------------------ supervisor
    def _supervise_loop(self) -> None:
        """One supervision thread per driver: respawns dead workers
        (queued by the receiver threads' ``_fail_channel``) and, when
        ``heartbeat_s`` is set, kills workers that have in-flight
        commands but no pipe activity within the deadline (a hung/
        suspended worker never breaks its own pipe — this turns a stall
        into a detectable death)."""
        poll = (min(self.heartbeat_s / 2, 0.2)
                if self.heartbeat_s else 0.5)
        while True:
            with self._respawn_cv:
                if not self._respawn_q and not self._closed:
                    self._respawn_cv.wait(poll)
                if self._closed:
                    return
                ch = self._respawn_q.popleft() if self._respawn_q else None
            if ch is not None:
                self._respawn(ch)
                continue
            if self.heartbeat_s is not None:
                self._check_stalls()

    def _check_stalls(self) -> None:
        now = time.monotonic()
        for sid in self._hb.dead_workers(now):
            ch = self._channels[sid]
            # only a worker with commands in flight can be "stalled" —
            # an idle worker legitimately sends nothing
            if ch.state == SHARD_UP and ch.pending and ch.proc.is_alive():
                self._kill_worker(sid, f"heartbeat missed "
                                       f"({self.heartbeat_s}s)")
            self._hb.beat(sid, now)    # one kill per stall detection

    def _respawn(self, ch: _ShardChannel) -> None:
        """Bring a dead shard back: fresh process, same region and
        capacity, store re-opened from its spec, kernel rebuilt cold.
        Slots with live client views are pre-reserved so stale reads
        stay valid; the restart budget turns a crash loop into a
        permanent, stable DOWN."""
        now = time.monotonic()
        if self._closed or self.arena._closed \
                or ch.state != SHARD_RESTARTING:
            return
        if not ch.budget.allow(now):
            ch.state = SHARD_DOWN
            self.fault_events.append({
                "sid": ch.sid, "kind": "down", "died_at": ch.died_at,
                "at": now, "generation": ch.generation,
                "restarts_used": ch.budget.used})
            return
        sp = self._spawn
        ctx = sp["ctx"]
        reserved = ch.begin_respawn()
        parent, child = ctx.Pipe()
        proc = ctx.Process(
            target=_worker_main,
            args=(child, self.arena.name, self.arena.region(ch.sid),
                  sp["spec"], sp["backing_spec"], ch.capacity, self.cfg,
                  self.options, ch.sid, sp["retry"], sp["pause_gc"],
                  reserved),
            name=f"igt-shard-{ch.sid}g{ch.generation + 1}", daemon=True)
        try:
            proc.start()
        except Exception:                   # pragma: no cover - fork failed
            ch.state = SHARD_DOWN
            self.fault_events.append({
                "sid": ch.sid, "kind": "down", "died_at": ch.died_at,
                "at": now, "generation": ch.generation,
                "restarts_used": ch.budget.used})
            return
        child.close()
        with ch.send_lock:
            ch.conn = parent
            ch.proc = proc
            ch.generation += 1
            ch.closed = False
            ch.state = SHARD_UP
        t = threading.Thread(target=self._receive, args=(ch,),
                             name=f"igt-chan-{ch.sid}g{ch.generation}",
                             daemon=True)
        ch.recv_thread = t
        t.start()
        self._threads.append(t)
        if self.heartbeat_s is not None:
            self._hb.beat(ch.sid, time.monotonic())
        # the kernel came back cold: replay the sticky controls and
        # refresh the capability info (best-effort — if it dies again
        # mid-replay the new receiver routes it back through here)
        try:
            for path in self._pin_log:
                self._rpc(ch.sid, "pin", path)
            for path in self._never_log:
                self._rpc(ch.sid, "never_cache", path)
            self.worker_info[ch.sid] = self._rpc(ch.sid, "hello", None)
        except (ShardUnavailableError, RuntimeError, TimeoutError):
            pass
        up_at = time.monotonic()
        self.fault_events.append({
            "sid": ch.sid, "kind": "respawn", "died_at": ch.died_at,
            "respawned_at": up_at, "recovery_s": up_at - ch.died_at,
            "generation": ch.generation,
            "restarts_used": ch.budget.used})

    def fault_stats(self) -> dict:
        """Supervision observability: per-shard state/generation/budget
        plus the chronological event log (kills, respawns with recovery
        time, permanent downs)."""
        return {
            "restarts": sum(ch.generation for ch in self._channels),
            "shards": {ch.sid: {"state": ch.state,
                                "generation": ch.generation,
                                "restarts_used": ch.budget.used,
                                "capacity": ch.capacity}
                       for ch in self._channels},
            "events": list(self.fault_events),
        }

    def shard_states(self) -> List[str]:
        return [ch.state for ch in self._channels]

    # ------------------------------------------------------------------ read
    def read(self, file_path: PathT, offset: int, size: int,
             now: float) -> WireOutcome:
        enc, _ = self._rpc(self.shard_id(file_path), "read",
                           (file_path, offset, size, now, self._inline))
        return WireOutcome(enc, file_path)

    def read_serial(self, file_path: PathT, offset: int, size: int,
                    now: float) -> WireOutcome:
        enc, _ = self._rpc(self.shard_id(file_path), "read_serial",
                           (file_path, offset, size, now, self._inline))
        return WireOutcome(enc, file_path)

    def read_batch(self, requests: Sequence[Tuple[PathT, int, int]],
                   now: float) -> List[WireOutcome]:
        """One round-trip per shard: all sub-batches are in flight
        before the first reply is awaited, so shard kernels execute the
        batch in parallel across processes."""
        requests = list(requests)
        if self.n_shards == 1:
            try:
                encs, _ = self._rpc(0, "read_batch",
                                    (requests, now, self._inline))
            except ShardUnavailableError as e:
                raise ShardUnavailableError(
                    str(e), sid=e.sid, state=e.state,
                    partial=[None] * len(requests),
                    indices=list(range(len(requests)))) from None
            return [WireOutcome(e, req[0])
                    for e, req in zip(encs, requests)]
        buckets = self.bucket_by_shard(requests)
        pending = [(sid, items, self._rpc_async(
                        sid, "read_batch",
                        ([r for _, r in items], now, self._inline)))
                   for sid, items in buckets.items()]
        outs: List[Optional[WireOutcome]] = [None] * len(requests)
        failed: List[int] = []
        first: Optional[ShardUnavailableError] = None
        for sid, items, rpc in pending:
            try:
                encs, _ = self._wait_rpc(sid, rpc)
            except ShardUnavailableError as e:
                # keep collecting the healthy shards' outcomes — the
                # error carries them so the client degrades only the
                # failed sub-batch instead of re-reading (and thereby
                # double-observing) the survivors
                if first is None:
                    first = e
                failed.extend(i for i, _ in items)
                continue
            for (i, req), enc in zip(items, encs):
                outs[i] = WireOutcome(enc, req[0])
        if first is not None:
            raise ShardUnavailableError(
                str(first), sid=first.sid, state=first.state,
                partial=outs, indices=sorted(failed)) from None
        return outs  # type: ignore[return-value]

    # ------------------------------------------------------------- prefetch
    def complete_prefetch(self, path: PathT, size: int, now: float) -> bool:
        try:
            return self._rpc(self.shard_id(path), "complete",
                             (path, size, now))
        except ShardUnavailableError:
            # the kernel died with its pending table — nothing to admit
            return False

    def cancel_prefetch(self, path: PathT) -> None:
        try:
            self._rpc(self.shard_id(path), "cancel", path)
        except ShardUnavailableError:
            pass                 # dead kernel: nothing left to leak

    # ------------------------------------------------------------------ tick
    def tick(self, now: float) -> None:
        """Per-shard maintenance plus, when due, the cross-shard round
        over the workers' serialized demand summaries.  Down/restarting
        shards are skipped — maintenance must not poison the callers.
        Unlike the in-process facade there is no starvation-triggered
        early round (spotting a sub-min-share CMU would cost an RPC
        sweep per tick); the retrying floor top-up inside the planner
        still repairs starvation on the next periodic round."""
        if (self.n_shards > 1 and self.options.allocation == "adaptive"
                and self.global_rebalancer.due(now)):
            self.rebalance_now(now)
        self._broadcast("tick", now, tolerant=True)

    def rebalance_now(self, now: float) -> int:
        """One cross-shard allocation round: gather ``DemandSummary``
        rows from the *reachable* workers, plan with the same greedy
        rule as the in-process facade, ship the deltas back.  A down
        shard contributes no rows, so its capacity is frozen exactly
        where it died — moves conserve capacity among the survivors and
        the cluster total stays intact for when it returns.  Returns the
        number of quantum moves applied."""
        reb = self.global_rebalancer
        reb.last_round = now
        summaries: List[ShardSummary] = [
            got for got in self._broadcast("rebalance_summary", now,
                                           tolerant=True)
            if got is not None]
        rows: List[DemandSummary] = [r for s in summaries for r in s.rows]
        moves = reb.plan_moves(rows)
        reb.note_round(now, summaries, moves)
        if not moves:
            return 0
        shrinks: Dict[int, List[Tuple[PathT, int]]] = {}
        grows: Dict[int, List[Tuple[PathT, int]]] = {}
        cap_delta: Dict[int, int] = {}
        for donor, taker, amt in moves:
            shrinks.setdefault(donor.shard, []).append((donor.key, amt))
            cap_delta[donor.shard] = cap_delta.get(donor.shard, 0) - amt
            cap_delta[taker.shard] = cap_delta.get(taker.shard, 0) + amt
            grows.setdefault(taker.shard, []).append((taker.key, amt))
        # client-tracked capacities move FIRST: they are what a respawn
        # hands the replacement worker, so even a death mid-apply keeps
        # sum(shard capacities) == cluster capacity
        for sid, delta in cap_delta.items():
            self._channels[sid].capacity += delta
        pending = [(sid, self._rpc_async(sid, "rebalance_apply",
                                         (shrinks.get(sid, []),
                                          cap_delta.get(sid, 0),
                                          grows.get(sid, []))))
                   for sid in cap_delta]
        for sid, rpc in pending:
            try:
                self._wait_rpc(sid, rpc)
            except ShardUnavailableError:
                pass   # respawn re-applies via ch.capacity
        return len(moves)

    # ------------------------------------------------------------- controls
    def pin(self, path: PathT) -> None:
        self._pin_log.append(path)    # replayed to respawned (cold) workers
        self._broadcast("pin", path, tolerant=True)

    def never_cache(self, path: PathT) -> None:
        self._never_log.append(path)
        self._broadcast("never_cache", path, tolerant=True)

    def invalidate_meta_cache(self) -> None:
        """Mid-run dataset change (the ``LocalFSStore.refresh``
        workflow): every worker re-walks its own store instance (the
        client-side store's ``refresh()`` cannot reach worker
        snapshots) and drops its kernel's memoized metadata; the
        client-side store is refreshed here too so planning
        (``_plan_ranges``) agrees with the workers."""
        refresh = getattr(self.meta, "refresh", None)
        if callable(refresh):
            refresh()
        self._broadcast("invalidate_meta", None, tolerant=True)

    # ----------------------------------------------------------------- stats
    def _channel_stats(self, ch: _ShardChannel) -> dict:
        """One shard's stats dict — live from the worker when it is UP,
        else the last reply seen before it died (capacity overridden
        with the client-tracked value, which stays authoritative across
        rebalances and respawns)."""
        if ch.state == SHARD_UP:
            try:
                got = self._rpc(ch.sid, "stats", None)
                ch.last_stats = got
                return got
            except ShardUnavailableError:
                pass
        got = dict(ch.last_stats) if ch.last_stats is not None else {
            "stats": CacheStats(), "nodes": 0, "used": 0, "cmus": 0,
            "pending": 0, "spills": 0, "arena_free": 0}
        got["capacity"] = ch.capacity
        return got

    def _gather_stats(self) -> List[dict]:
        out = []
        for ch in self._channels:
            g = self._channel_stats(ch)
            if ch.generation > 0:
                # fold in the counters carried over from generations
                # that died (a respawned kernel restarts from zero)
                g = dict(g)
                g["stats"] = CacheStats.merged([ch.stats_carry,
                                                g["stats"]])
            out.append(g)
        return out

    @property
    def stats(self) -> CacheStats:
        """Point-in-time merge of the worker kernels' counters (same
        snapshot semantic as ``ShardedIGTCache.stats``)."""
        return CacheStats.merged(g["stats"] for g in self._gather_stats())

    def hit_ratio(self) -> float:
        return self.stats.hit_ratio

    def used_bytes(self) -> int:
        return sum(g["used"] for g in self._gather_stats())

    def node_count(self) -> int:
        return sum(g["nodes"] for g in self._gather_stats())

    def shard_capacities(self) -> List[int]:
        return [g["capacity"] for g in self._gather_stats()]

    def arena_spills(self) -> int:
        """Fetch results that could not get an arena slot and fell back
        to an inline (pickled) reply — 0 means every payload byte
        crossed through shared memory."""
        return sum(g["spills"] for g in self._gather_stats())

    def pending_prefetch_count(self) -> int:
        """Total candidates pending in the worker kernels (leak probe
        for the executor-contract tests)."""
        return sum(g["pending"] for g in self._gather_stats())

    def snapshot(self) -> dict:
        gathered = self._gather_stats()
        s = CacheStats.merged(g["stats"] for g in gathered).snapshot()
        s["nodes"] = sum(g["nodes"] for g in gathered)
        s["cmus"] = sum(g["cmus"] for g in gathered)
        s["used_bytes"] = sum(g["used"] for g in gathered)
        s["arena_spills"] = sum(g["spills"] for g in gathered)
        return s

    def workload_cmus(self) -> list:
        return [c for _, c in self.iter_workload_cmus()]

    def iter_workload_cmus(self):
        """(root_path, summary) pairs.  The CMUs live in the worker
        processes; what crosses back is a read-only :class:`CmuView`
        (quota/used/hits/misses/pattern), not the live object."""
        for sid in range(self.n_shards):
            if self._channels[sid].state != SHARD_UP:
                continue
            try:
                rows = self._rpc(sid, "cmus", None)
            except ShardUnavailableError:
                continue
            for path, pat, quota, used, hits, misses in rows:
                yield tuple(path), CmuView(tuple(path), Pattern(pat),
                                           quota, used, hits, misses)

    # ------------------------------------------------------------- executor
    def _register_executor(self,
                           executor: Optional["ProcessExecutor"]) -> None:
        # under the lock so a receiver thread mid-death-accounting can
        # never race an executor attaching/detaching (the
        # death-during-close stats race)
        with self._executor_lock:
            self._executor = executor

    def flush(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for ch in self._channels:
            rem = None if deadline is None else deadline - time.monotonic()
            if not ch.wait_idle(rem):
                return False
        return True

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: float = 5.0) -> None:
        """Stop the workers and release the arena.  Queued background
        candidates are dropped (close the attached executor *first* if
        its accounting must balance — ``CacheClient.close`` does)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # stop the supervisor first: no respawns may race the shutdown
        with self._respawn_cv:
            self._respawn_q.clear()
            self._respawn_cv.notify_all()
        if self._supervisor is not None:
            self._supervisor.join(timeout=timeout)
        for ch in self._channels:
            ch.drain_background()
        # the stop command rides the normal FIFO, so every in-flight
        # command drains first; the receiver exits on the stop reply
        stops = [self._rpc_async(ch.sid, "stop", None)
                 for ch in self._channels]
        for rpc in stops:
            try:
                rpc.wait(timeout)
            except Exception:
                pass
        for ch in self._channels:
            with ch.send_lock:
                ch.closed = True
        for t in self._threads:
            t.join(timeout=timeout)
        for ch in self._channels:
            ch.proc.join(timeout=timeout)
            if ch.proc.is_alive():          # pragma: no cover - stuck worker
                ch.proc.terminate()         # breaks the pipe → receiver
                ch.proc.join(timeout=1.0)   # wakes and fails its pending
        for t in self._threads:             # pragma: no cover - stuck worker
            if t.is_alive():
                t.join(timeout=1.0)
        for ch in self._channels:
            try:
                ch.conn.close()
            except OSError:                 # pragma: no cover
                pass
        self.arena.close()
        self._finalizer.detach()

    def __enter__(self) -> "ProcessShardedCache":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _cleanup_leftovers(arena: ShmArena, channels) -> None:
    """GC / interpreter-exit safety net: never leak worker processes or
    the shared-memory block when a driver is dropped without close()."""
    for ch in channels:
        if ch.proc.is_alive():
            ch.proc.terminate()
    arena.close()


class CmuView:
    """Read-only CMU summary shipped from a worker (the process driver's
    ``iter_workload_cmus`` payload — live CMUs cannot cross the pipe)."""

    __slots__ = ("root_path", "pattern", "quota", "used", "hits", "misses",
                 "substreams")

    def __init__(self, root_path, pattern, quota, used, hits, misses):
        self.root_path = root_path
        self.pattern = pattern
        self.quota = quota
        self.used = used
        self.hits = hits
        self.misses = misses
        self.substreams: dict = {}

    def effective_pattern(self) -> Pattern:
        return self.pattern


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------

class ProcessExecutor(PrefetchExecutor):
    """`PrefetchExecutor` over a :class:`ProcessShardedCache`.

    Candidates route to their shard's background queue (bounded,
    deduped); the shard's dispatcher coalesces them into
    ``prefetch_batch`` commands that fetch + complete **inside the
    worker process** — the client never touches prefetch bytes.  Demand
    fetches are demand-class RPCs served via the shared-memory arena.
    Dedup/overflow/shutdown cancellations reach the worker kernel as
    batched ``cancel_many`` commands, so the pending tables never leak
    and ``submitted == completed + cancelled + deduped`` holds at close.
    """

    def __init__(self, queue_depth: int = 4096,
                 max_fetch_bytes: int = 4096) -> None:
        super().__init__()
        self.queue_depth = queue_depth
        self.max_fetch_bytes = max_fetch_bytes
        self.driver: Optional[ProcessShardedCache] = None
        self._closed = False

    def attach(self, engine, backing, guard, clock, retry=None) -> None:
        if not isinstance(engine, ProcessShardedCache):
            raise TypeError(
                "ProcessExecutor needs a ProcessShardedCache engine "
                f"(driver='process'), got {type(engine).__name__}")
        super().attach(engine, backing, guard, clock, retry)
        self.driver = engine
        engine._register_executor(self)

    # -- candidate path -----------------------------------------------------
    def submit(self, candidates: Sequence[Tuple[PathT, int]],
               now: float) -> None:
        if not candidates:
            return
        from .cache import path_key
        d = self.driver
        if self._closed:
            # release the kernel's pending entries, then fail loudly —
            # same close-vs-submit semantics as the ThreadedExecutor
            self._cancel_candidates(candidates)
            raise RuntimeError("submit() on a closed ProcessExecutor")
        with self._stats_lock:
            self.stats.submitted += len(candidates)
        cancels: Dict[int, List[PathT]] = {}
        touched: Set[int] = set()
        for path, size in candidates:
            sid = d.shard_id(path)
            got = d._channels[sid].offer_background(
                path, size, path_key(path), now, self.queue_depth)
            if got == "queued":
                touched.add(sid)
                continue
            with self._stats_lock:
                if got == "dup":
                    self.stats.deduped += 1
                else:                       # full / closed
                    self.stats.cancelled += 1
            cancels.setdefault(sid, []).append(path)
        for sid, paths in cancels.items():
            d._rpc_async(sid, "cancel_many", paths)   # fire-and-forget
        for sid in touched:                 # kick the coalescing pump
            d._pump_prefetch(d._channels[sid])

    def _cancel_candidates(self, candidates) -> None:
        d = self.driver
        with self._stats_lock:
            self.stats.submitted += len(candidates)
            self.stats.cancelled += len(candidates)
        by: Dict[int, List[PathT]] = {}
        for path, _size in candidates:
            by.setdefault(d.shard_id(path), []).append(path)
        for rpc in [d._rpc_async(sid, "cancel_many", paths)
                    for sid, paths in by.items()]:
            try:
                rpc.wait(5.0)
            except Exception:
                pass

    # -- demand path --------------------------------------------------------
    def fetch_demand(self, requests) -> List[np.ndarray]:
        """Split the demand ranges by shard, one ``fetch`` RPC each (all
        in flight before the first wait → shard-parallel ``fetch_many``
        against per-process stores), bytes back through the arena."""
        d = self.driver
        with self._stats_lock:
            self.stats.demand_fetches += len(requests)
        pending = [(sid, items,
                    d._rpc_async(sid, "fetch", [req for _, req in items]))
                   for sid, items in d.bucket_by_shard(requests).items()]
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        error: Optional[BaseException] = None
        for sid, items, rpc in pending:
            try:
                entries, retries = d._wait_rpc(sid, rpc)
            except BaseException as e:
                with self._stats_lock:
                    self.stats.fetch_errors += 1
                if error is None:
                    error = e
                continue
            with self._stats_lock:
                self.stats.retries += retries
            ch = d._channels[sid]
            for (i, _), entry in zip(items, entries):
                if entry[0] == "raw":
                    out[i] = np.asarray(entry[1], dtype=np.uint8)
                else:
                    out[i] = d.arena.view(entry[1], entry[2],
                                          on_release=ch.queue_free)
        if error is not None:
            raise error                     # re-raise in the reader's thread
        return out  # type: ignore[return-value]

    # -- lifecycle ----------------------------------------------------------
    def flush(self, timeout: Optional[float] = None) -> bool:
        return self.driver.flush(timeout) if self.driver else True

    def close(self, cancel_pending: bool = True) -> None:
        if self._closed or self.driver is None:
            return
        if not cancel_pending:
            self.flush()
        self._closed = True
        d = self.driver
        pending = []
        for ch in d._channels:
            drained = ch.drain_background()
            if not drained:
                continue
            with self._stats_lock:
                self.stats.cancelled += len(drained)
            pending.append(d._rpc_async(ch.sid, "cancel_many",
                                        [p for p, _, _, _ in drained]))
        for rpc in pending:
            try:
                rpc.wait(5.0)
            except Exception:
                pass
        # in-flight prefetch batches finish on their own; wait so the
        # stats identity holds the moment close() returns
        self.flush(timeout=10.0)
        d._register_executor(None)
