"""The unified storage API: BackingStore v2 + URI-addressed store registry.

The PR-3 client reduced "where do bytes come from" to a single blocking
``fetch_block(path, size)`` seam.  That was enough for the simulator but
not for real backends: no sub-block ranges (partial-extent reads
over-fetch whole blocks), no batching (multi-shard demand misses fetch
serially), no failure semantics (a flaky backend kills a worker or hangs
a reader), and no way to *name* a store.  This module is the redesigned
storage surface every backend plugs into (Hoard arXiv:1812.00669 draws
the same adapter line between cache service and storage backends):

* :class:`BackingStore` — the v2 protocol: ``fetch_range(path, offset,
  length)``, ``fetch_many(requests)``, ``capabilities()``, with the
  legacy ``fetch_block`` kept as a derived method;
* :class:`StoreCapabilities` — capability negotiation (native ranges,
  native batching, safe fan-out) so clients can plan fetches;
* :class:`StoreError` / :class:`TransientStoreError` — the typed error
  taxonomy, and :class:`RetryPolicy` — bounded retry + backoff on
  transient errors (permanent errors propagate immediately);
* :func:`register_scheme` / :func:`open_store` — the URI front door
  (``sim://``, ``file:///dir``, ``mem://``, ``faulty+<scheme>://``);
* :class:`StoreMetaIndex` — the dict-backed ``core.meta.StoreMeta``
  implementation shared by the simulated store, the local-filesystem
  walker and the in-memory test store;
* :class:`LegacyStoreAdapter` / :func:`as_backing_store` — the shim that
  keeps third-party one-method ``fetch_block`` stores working unchanged.

Addressing convention: fetch paths accept either a *file path* tuple or
a *block path* (file path + ``"#<n>"`` leaf, built by
``core.types.block_key``).  For a block path, ``offset`` is relative to
the block start; stores resolve it to an absolute file offset via their
``block_size``.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)
from urllib.parse import parse_qsl, unquote, urlsplit, urlunsplit

import numpy as np

from ..core.types import MB, PathT, block_key, split_block_key

__all__ = [
    "BackingStore", "CircuitBreaker", "CircuitOpenError", "DeadlineError",
    "FaultyStore", "LegacyStoreAdapter", "MemStore",
    "RangeRequest", "RetryPolicy", "StoreCapabilities", "StoreError",
    "StoreMetaIndex", "TransientStoreError", "as_backing_store",
    "open_store", "register_scheme", "registered_schemes",
    "resolve_store_spec", "store_spec",
]

# One demand fetch: (file-or-block path, offset within it, length).
RangeRequest = Tuple[PathT, int, int]


# ---------------------------------------------------------------------------
# error taxonomy + retry
# ---------------------------------------------------------------------------

class StoreError(Exception):
    """Permanent storage failure: retrying cannot help (missing object,
    corrupt range, misconfigured backend).  Callers must propagate it and
    release any kernel state tied to the fetch."""


class TransientStoreError(StoreError):
    """Retryable storage failure (timeout, throttling, flaky link).  The
    client's :class:`RetryPolicy` absorbs these up to its attempt bound;
    past the bound the error propagates like a permanent one."""


class DeadlineError(StoreError):
    """The caller's time budget ran out before the fetch succeeded.

    Raised by :meth:`RetryPolicy.call` when ``deadline_s`` is set and the
    next retry (or the attempt just finished) would land past the budget.
    Permanent by design: a reader blocked on a sick store gets a fast,
    typed error instead of an unbounded wait — it can then fall back
    (degraded read) or surface the failure."""


class CircuitOpenError(TransientStoreError):
    """Fast-failed by an OPEN circuit breaker: the store has been failing
    consecutively and callers are short-circuited until the half-open
    probe window.  Transient by taxonomy (the breaker will half-open),
    but :class:`RetryPolicy` does **not** retry it — retrying against an
    open breaker is exactly the hammering the breaker exists to stop."""


class CircuitBreaker:
    """Per-store circuit breaker: CLOSED → OPEN after ``threshold``
    *consecutive* transient failures, OPEN → HALF_OPEN after
    ``reset_s``, HALF_OPEN → CLOSED on one success (or back to OPEN on
    failure).

    Only transient failures count (permanent errors already fail fast
    and retrying cannot help, so they carry no load signal).  While OPEN,
    ``before_call`` raises :class:`CircuitOpenError` immediately —
    callers get a fast error instead of burning their deadline against a
    store that has been failing for everyone.  In HALF_OPEN exactly one
    caller at a time is let through as the probe.

    Thread-safe; ``clock`` is injectable for virtual-time tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 5, reset_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.reset_s = reset_s
        self.clock = clock
        self._lock = threading.Lock()
        self._failures = 0            # consecutive transient failures
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probing = False         # half-open: one probe in flight
        self.trips = 0                # times the breaker opened
        self.fast_failures = 0        # calls short-circuited while open

    @property
    def state(self) -> str:
        with self._lock:
            return self._peek_state()

    def _peek_state(self) -> str:
        if (self._state == self.OPEN
                and self.clock() - self._opened_at >= self.reset_s):
            return self.HALF_OPEN
        return self._state

    def before_call(self) -> None:
        """Admission check: raises :class:`CircuitOpenError` while OPEN;
        in HALF_OPEN admits a single probe and fast-fails the rest."""
        with self._lock:
            state = self._peek_state()
            if state == self.CLOSED:
                return
            if state == self.HALF_OPEN and not self._probing:
                self._state = self.HALF_OPEN
                self._probing = True
                return
            self.fast_failures += 1
            raise CircuitOpenError(
                f"circuit breaker open ({self._failures} consecutive "
                f"transient failures; retry after {self.reset_s}s)")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probing = False
            if self._state == self.HALF_OPEN or \
                    self._failures >= self.threshold:
                if self._state != self.OPEN:
                    self.trips += 1
                self._state = self.OPEN
                self._opened_at = self.clock()

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._peek_state(),
                    "consecutive_failures": self._failures,
                    "trips": self.trips,
                    "fast_failures": self.fast_failures}


@dataclass
class RetryPolicy:
    """Bounded retry + exponential backoff for transient store errors.

    Only :class:`TransientStoreError` is retried; permanent
    :class:`StoreError` and unrelated exceptions propagate immediately.
    ``sleep`` is injectable so tests (and virtual-clock callers) retry
    without wall-clock delay.

    ``deadline_s`` is the *total* time budget across all attempts: when
    set, an attempt is never started (and a backoff never slept) past
    ``start + deadline_s`` — the call raises :class:`DeadlineError`
    instead, so a hanging or endlessly-flaky store costs a bounded wait.
    ``breaker`` (a :class:`CircuitBreaker`, also overridable per call)
    is consulted before and after every attempt: an OPEN breaker fails
    the call immediately with :class:`CircuitOpenError` (never retried).
    """

    max_attempts: int = 3
    backoff_s: float = 0.005
    multiplier: float = 2.0
    max_backoff_s: float = 0.5
    deadline_s: Optional[float] = None
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)
    clock: Callable[[], float] = field(default=time.monotonic, repr=False)
    breaker: Optional[CircuitBreaker] = field(default=None, repr=False)

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             breaker: Optional[CircuitBreaker] = None,
             deadline_s: Optional[float] = None):
        """Run ``fn(*args)``, retrying transient failures.  ``on_retry``
        (attempt number, error) fires before each re-attempt — the
        executor's retry accounting hooks in there.  ``breaker`` /
        ``deadline_s`` override the policy's own when given."""
        breaker = breaker if breaker is not None else self.breaker
        budget = deadline_s if deadline_s is not None else self.deadline_s
        deadline = None if budget is None else self.clock() + budget
        delay = self.backoff_s
        attempts = max(1, self.max_attempts)
        for attempt in range(1, attempts + 1):
            if breaker is not None:
                breaker.before_call()      # CircuitOpenError: never retried
            try:
                result = fn(*args)
            except CircuitOpenError:
                raise                      # a nested breaker fast-failed
            except TransientStoreError as e:
                if breaker is not None:
                    breaker.record_failure()
                if attempt >= attempts:
                    raise
                if deadline is not None and \
                        self.clock() + delay >= deadline:
                    raise DeadlineError(
                        f"retry budget ({budget}s) exhausted after "
                        f"{attempt} attempt(s): {e}") from e
                if on_retry is not None:
                    on_retry(attempt, e)
                self.sleep(delay)
                delay = min(delay * self.multiplier, self.max_backoff_s)
            else:
                if breaker is not None:
                    breaker.record_success()
                if deadline is not None and self.clock() > deadline:
                    # the attempt itself blew the budget (hung store):
                    # the caller asked for a bounded wait, so a late
                    # success still reports the deadline breach — but the
                    # data is here, so return it (the *next* call against
                    # the still-sick store is the breaker's job).
                    return result
                return result


# ---------------------------------------------------------------------------
# the v2 protocol
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StoreCapabilities:
    """What a store can do natively — the negotiation surface clients use
    to plan fetches (everything still *works* without a capability; the
    protocol's default methods fall back to derived implementations)."""

    ranges: bool = False       # sub-block ranged reads without over-fetch
    batching: bool = False     # fetch_many is better than a serial loop
    concurrency: int = 1       # safe parallel fan-out hint for callers

    def snapshot(self) -> dict:
        return {"ranges": self.ranges, "batching": self.batching,
                "concurrency": self.concurrency}


class BackingStore:
    """Protocol + derived methods for the byte source behind the cache.

    Implementations provide ``fetch_range``; ``fetch_many`` and the
    legacy ``fetch_block`` derive from it (override when the backend can
    do better — e.g. one filesystem open per file, one S3 multi-range
    request).  Failures must be raised as :class:`StoreError` /
    :class:`TransientStoreError` so the client's retry and cancellation
    paths can tell them apart.
    """

    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities()

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        """Bytes ``[offset, offset+length)`` of ``path`` (block-relative
        when ``path`` is a block path) as a uint8 array."""
        raise NotImplementedError

    def fetch_many(self, requests: Sequence[RangeRequest]
                   ) -> List[np.ndarray]:
        """Serve a batch of range requests, results in request order."""
        return [self.fetch_range(p, o, n) for p, o, n in requests]

    def fetch_block(self, path: PathT, size: int) -> np.ndarray:
        """Legacy v1 surface: the first ``size`` bytes of a block."""
        return self.fetch_range(path, 0, size)


class LegacyStoreAdapter(BackingStore):
    """v2 facade over a one-method ``fetch_block(path, size)`` store.

    Ranged reads over-fetch the block prefix and slice — exactly what
    every caller did before this API existed — so third-party stores
    written against the PR-3 protocol keep working unchanged (they just
    don't get the ranged/batched savings, and ``capabilities()`` says so).
    """

    def __init__(self, store) -> None:
        self.inner = store

    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities(ranges=False, batching=False, concurrency=1)

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        data = self.inner.fetch_block(path, offset + length)
        return np.asarray(data[offset:offset + length], dtype=np.uint8)

    def fetch_block(self, path: PathT, size: int) -> np.ndarray:
        return self.inner.fetch_block(path, size)

    def __getattr__(self, name):
        # StoreMeta passthrough: the wrapped store often doubles as the
        # kernel's metadata source (RemoteStore does).
        return getattr(self.inner, name)


def as_backing_store(store) -> Optional[BackingStore]:
    """Normalize anything byte-serving onto the v2 protocol.

    Detection is *type-level* (``__getattr__`` delegation on a wrapper
    must not masquerade as native v2 support — the wrapper's own gating
    or counting would be silently bypassed).  Returns ``None`` for
    metadata-only objects so callers keep the "no backing store"
    behavior.
    """
    if store is None:
        return None
    if callable(getattr(type(store), "fetch_range", None)):
        return store
    if callable(getattr(type(store), "fetch_block", None)):
        return LegacyStoreAdapter(store)
    return None


# ---------------------------------------------------------------------------
# shared StoreMeta implementation
# ---------------------------------------------------------------------------

class StoreMetaIndex:
    """Dict-backed ``core.meta.StoreMeta``: ordered listings, file sizes,
    subtree byte totals, block-key enumeration and the flattened global
    block index (dataset = top-level path component).  The simulated
    object store, the local-filesystem walker and the in-memory test
    store all serve metadata from this one implementation."""

    block_size: int = 4 * MB

    def __init__(self) -> None:
        self._files: Dict[PathT, int] = {}           # path -> size, walk order
        self._dirs: Dict[PathT, List[str]] = {}
        self._index: Dict[Tuple[PathT, str], int] = {}
        self._subtree_bytes: Dict[PathT, int] = {}
        self._flat_index: Dict[PathT, Tuple[int, int]] = {}

    # -- registration --------------------------------------------------------
    def _register_file(self, path: PathT, size: int) -> None:
        self._files[path] = size

    def _register_dir(self, parent: PathT, names: List[str]) -> None:
        self._dirs[parent] = names
        for i, n in enumerate(names):
            self._index[(parent, n)] = i

    def _invalidate_derived(self) -> None:
        self._subtree_bytes.clear()
        self._flat_index.clear()

    # -- StoreMeta protocol --------------------------------------------------
    def listing(self, path: PathT) -> List[str]:
        return self._dirs.get(path, [])

    def listing_size(self, path: PathT) -> int:
        return len(self._dirs.get(path, ()))

    def child_index(self, path: PathT, name: str) -> int:
        return self._index.get((path, name), 0)

    def is_file(self, path: PathT) -> bool:
        return path in self._files

    def file_size(self, path: PathT) -> int:
        return self._files.get(path, 0)

    def subtree_bytes(self, path: PathT) -> int:
        cached = self._subtree_bytes.get(path)
        if cached is not None:
            return cached
        total = 0
        for fpath, size in self._files.items():
            if fpath[:len(path)] == path:
                total += size
        self._subtree_bytes[path] = total
        return total

    def iter_block_keys(self, path: PathT,
                        block_size: Optional[int] = None
                        ) -> Iterator[Tuple[PathT, int]]:
        bs = block_size or self.block_size
        for fpath, size in self._files.items():
            if fpath[:len(path)] != path:
                continue
            nblocks = max(1, -(-size // bs))
            for b in range(nblocks):
                yield block_key(fpath, b), min(bs, size - b * bs)

    def flat_block_index(self, file_path: PathT, block: int,
                         block_size: Optional[int] = None) -> Tuple[int, int]:
        """Global block ordinal within the file's top-level component
        (walk order) — the flattened index space of §3.2."""
        if not self._flat_index:
            self._build_flat_index(block_size or self.block_size)
        start, total = self._flat_index.get(file_path, (0, 1))
        return start + block, total

    def _build_flat_index(self, block_size: int) -> None:
        per_top_cursor: Dict[str, int] = {}
        starts: Dict[PathT, int] = {}
        for fpath, size in self._files.items():   # insertion = walk order
            top = fpath[0]
            cur = per_top_cursor.get(top, 0)
            starts[fpath] = cur
            per_top_cursor[top] = cur + max(1, -(-size // block_size))
        for fpath in starts:
            self._flat_index[fpath] = (starts[fpath],
                                       per_top_cursor[fpath[0]])

    # -- shared range resolution --------------------------------------------
    def _absolute_range(self, path: PathT, offset: int,
                        length: int) -> Tuple[PathT, int]:
        """(file_path, absolute offset) for a file-or-block path."""
        file_path, b = split_block_key(path)
        if b is not None:
            offset += b * self.block_size
        return file_path, offset


# ---------------------------------------------------------------------------
# in-memory store (tests / fixtures)
# ---------------------------------------------------------------------------

class MemStore(StoreMetaIndex, BackingStore):
    """In-memory store: real bytes, real metadata, zero I/O — the test
    double for the full v2 + StoreMeta contract (``mem://``)."""

    def __init__(self, block_size: int = 4 * MB) -> None:
        super().__init__()
        self.block_size = block_size
        self._data: Dict[PathT, np.ndarray] = {}

    def add_file(self, path: PathT, data: bytes) -> None:
        path = tuple(path)
        if path not in self._files:
            for depth in range(len(path)):
                parent, name = path[:depth], path[depth]
                names = self._dirs.setdefault(parent, [])
                if (parent, name) not in self._index:
                    self._index[(parent, name)] = len(names)
                    names.append(name)
        self._register_file(path, len(data))
        self._data[path] = np.frombuffer(bytes(data), dtype=np.uint8).copy()
        self._invalidate_derived()

    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities(ranges=True, batching=True, concurrency=8)

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        file_path, abs_off = self._absolute_range(path, offset, length)
        data = self._data.get(file_path)
        if data is None:
            raise StoreError(f"mem://: no such file {'/'.join(file_path)}")
        end = abs_off + length
        if abs_off < 0 or end > len(data):
            raise StoreError(
                f"mem://: range [{abs_off}, {end}) outside "
                f"{'/'.join(file_path)} ({len(data)} bytes)")
        view = data[abs_off:end]
        # zero-copy, but never a *writable* window into the store: a
        # caller mutating ReadResult.data must not corrupt the backend
        view.flags.writeable = False
        return view


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

class FaultyStore(BackingStore):
    """Fault-injecting wrapper over any store (``faulty+<scheme>://``).

    Every fetch request independently draws from a seeded RNG: with
    ``permanent_rate`` it raises :class:`StoreError`, with ``fail_rate``
    a :class:`TransientStoreError`, otherwise it (optionally) sleeps an
    exponential latency jitter of mean ``jitter_s`` and delegates.
    Metadata calls pass through untouched, so the wrapped store still
    backs the kernel.  Injection counters (``injected_transient`` /
    ``injected_permanent``) make retry-accounting tests exact.

    Chaos modes for the fault harness:

    * ``hang_rate`` / ``hang_s`` — with probability ``hang_rate`` a fetch
      stalls for ``hang_s`` before delegating: a *bounded* hang, so a
      deadline-less caller is slow, not stuck forever, and tests never
      truly wedge.  A caller with ``RetryPolicy.deadline_s < hang_s``
      observes the stall as a deadline breach.
    * ``slow_s`` — constant latency added to every fetch (a uniformly
      sick store rather than a lottery).
    * ``corrupt_rate`` — the fetch succeeds but the payload comes back
      bit-flipped (XOR 0xFF), for end-to-end checksum/validation paths.

    Counters: ``injected_hangs``, ``injected_corrupt``.
    """

    def __init__(self, inner, *, fail_rate: float = 0.0,
                 permanent_rate: float = 0.0, jitter_s: float = 0.0,
                 hang_rate: float = 0.0, hang_s: float = 0.0,
                 slow_s: float = 0.0, corrupt_rate: float = 0.0,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        backing = as_backing_store(inner)
        if backing is None:
            raise TypeError(
                f"FaultyStore needs a byte-serving store, got {inner!r}")
        self.inner = inner            # metadata passthrough target
        self._backing = backing       # normalized fetch target
        self.fail_rate = fail_rate
        self.permanent_rate = permanent_rate
        self.jitter_s = jitter_s
        self.hang_rate = hang_rate
        self.hang_s = hang_s
        self.slow_s = slow_s
        self.corrupt_rate = corrupt_rate
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()   # Generator + counters: not MT-safe
        self._sleep = sleep
        self.injected_transient = 0
        self.injected_permanent = 0
        self.injected_hangs = 0
        self.injected_corrupt = 0

    def capabilities(self) -> StoreCapabilities:
        return self._backing.capabilities()

    def __getstate__(self):
        # picklable for spawn/forkserver shard workers (the lock is
        # process-local state; each process draws from its own copy of
        # the seeded RNG stream)
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _roll(self, what: str) -> bool:
        # concurrent shard workers + readers all fetch through here —
        # draw and count under one lock so the injection counters stay
        # exact (the retry-accounting tests equate them to stats.retries).
        # Returns whether this fetch's payload should come back corrupt.
        with self._lock:
            r = self._rng.random()
            jitter = (float(self._rng.exponential(self.jitter_s))
                      if self.jitter_s > 0.0 else 0.0)
            hang = (self.hang_rate > 0.0 and self.hang_s > 0.0
                    and self._rng.random() < self.hang_rate)
            corrupt = (self.corrupt_rate > 0.0
                       and self._rng.random() < self.corrupt_rate)
            if hang:
                self.injected_hangs += 1
            if r < self.permanent_rate:
                self.injected_permanent += 1
                raise StoreError(f"injected permanent failure on {what}")
            if r < self.permanent_rate + self.fail_rate:
                self.injected_transient += 1
                raise TransientStoreError(
                    f"injected transient failure on {what}")
            if corrupt:
                self.injected_corrupt += 1
        stall = self.slow_s + jitter + (self.hang_s if hang else 0.0)
        if stall:
            self._sleep(stall)
        return corrupt

    @staticmethod
    def _mangle(data: np.ndarray) -> np.ndarray:
        # bit-flip every byte: unambiguous corruption that any checksum
        # (or byte-equality assertion) catches, with the right length
        return np.bitwise_xor(np.asarray(data, dtype=np.uint8), 0xFF)

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        corrupt = self._roll("/".join(path))
        data = self._backing.fetch_range(path, offset, length)
        return self._mangle(data) if corrupt else data

    def fetch_many(self, requests: Sequence[RangeRequest]
                   ) -> List[np.ndarray]:
        # inject per request: one bad range fails the batch, like a real
        # multi-range response with a failed part
        return [self.fetch_range(p, o, n) for p, o, n in requests]

    def fetch_block(self, path: PathT, size: int) -> np.ndarray:
        return self.fetch_range(path, 0, size)

    def __getattr__(self, name):
        return getattr(self.inner, name)


# ---------------------------------------------------------------------------
# URI scheme registry
# ---------------------------------------------------------------------------

_SCHEMES: Dict[str, Callable] = {}
_BUILTINS_LOADED = False


def register_scheme(scheme: str, factory: Callable) -> None:
    """Register ``factory(url, **params) -> store`` for ``scheme://``
    URIs.  ``url`` is the ``urlsplit`` result; ``params`` are the query
    items with numeric/bool coercion applied."""
    _SCHEMES[scheme] = factory


def registered_schemes() -> List[str]:
    _ensure_builtin_schemes()
    return sorted(_SCHEMES)


def _ensure_builtin_schemes() -> None:
    """Built-in backends register at import; imported lazily so
    ``storage.api`` stays importable on its own."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    from . import local_fs, object_store  # noqa: F401  (register on import)
    from . import s3  # noqa: F401  (s3:// + mock-s3://)
    # cache:// — daemon endpoint addresses (repro.daemon), resolving to
    # a DaemonAddress handle rather than a byte store; open_cache turns
    # one into a connected RemoteCacheClient
    from ..daemon import uri as _daemon_uri  # noqa: F401


def _coerce(value: str):
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return unquote(value)


def open_store(uri: str, **overrides):
    """The storage front door: ``open_store("scheme://...") -> store``.

    Built-in schemes:

    * ``sim://default`` — the simulated object store (``RemoteStore``);
      query params feed the transfer model (``latency_s``,
      ``bandwidth_Bps``).
    * ``file:///abs/dir`` — :class:`~repro.storage.local_fs.LocalFSStore`
      over a real directory tree (query: ``block_size``).
    * ``mem://`` — empty :class:`MemStore` (query: ``block_size``).
    * ``cache:///run/igt.sock`` / ``cache://host:port`` — a running
      cache daemon's endpoint (``repro.daemon``).  Resolves to a
      ``DaemonAddress`` handle, not a byte store; hand it (or the URI)
      to ``open_cache`` to connect a thin remote client.
    * ``s3://host:port/bucket`` — ranged object store over HTTP
      (``repro.storage.s3.S3Store``; query: ``block_size``,
      ``timeout_s``); ``mock-s3://<name>/<bucket>?dirs=D&files=N&
      file_kb=K&seed=S`` — the same store pointed at a deterministic
      in-process loopback server built from the URI spec.
    * ``tiered+<scheme>://...`` — the inner scheme's store wrapped in a
      :class:`~repro.storage.tiers.TieredStore` (RAM tier +
      spill-to-disk tier with pattern-aware placement); query params
      configure the tiers (``ram_mb``/``ram_bytes``,
      ``disk_mb``/``disk_bytes``, ``spill_dir``, ``mode``,
      ``target_hit_rate``, ``hit_window``).
    * ``faulty+<scheme>://...`` — the inner scheme's store wrapped in a
      :class:`FaultyStore`; query params configure the injector
      (``fail_rate``, ``permanent_rate``, ``jitter_s``, ``hang_rate``,
      ``hang_s``, ``slow_s``, ``corrupt_rate``, ``seed``).

    Wrapper schemes compose left-to-right (``faulty+tiered+sim://...``
    injects faults *above* the tiers; ``tiered+faulty+mem://...`` hides
    injected faults behind tier hits).  The composed URI is stamped on
    the outermost wrapper, so ``store_spec`` reconstructs the whole
    stack — injector, tiers and inner store — in a respawned worker.

    ``overrides`` win over query params.  Unknown schemes raise
    ``ValueError`` listing what is registered.
    """
    _ensure_builtin_schemes()
    url = urlsplit(uri)
    if not url.scheme:
        raise ValueError(f"store URI {uri!r} has no scheme "
                         f"(expected one of {registered_schemes()})")
    params = {k: _coerce(v) for k, v in parse_qsl(url.query)}
    params.update(overrides)
    if url.scheme.startswith("faulty+"):
        inner_uri = urlunsplit((url.scheme[len("faulty+"):], url.netloc,
                                url.path, "", ""))
        fault_keys = ("fail_rate", "permanent_rate", "jitter_s",
                      "hang_rate", "hang_s", "slow_s", "corrupt_rate",
                      "seed", "sleep")
        fault_kw = {k: params.pop(k) for k in fault_keys if k in params}
        inner = open_store(inner_uri, **params)
        wrapper = FaultyStore(inner, **fault_kw)
        # stamp the *composed* URI on the wrapper: without it,
        # ``store_spec`` would read ``uri``/``reopen_by_uri`` through
        # ``__getattr__`` delegation from the inner store and a respawned
        # worker would silently reconstruct the stack *without* fault
        # injection (the registry double-wrap bug)
        _record_uri(wrapper, uri)
        return wrapper
    if url.scheme.startswith("tiered+"):
        from .tiers import TIER_KEYS, TieredStore
        inner_uri = urlunsplit((url.scheme[len("tiered+"):], url.netloc,
                                url.path, "", ""))
        tier_kw = {k: params.pop(k) for k in TIER_KEYS if k in params}
        inner = open_store(inner_uri, **params)
        wrapper = TieredStore(inner, **tier_kw)
        _record_uri(wrapper, uri)
        return wrapper
    factory = _SCHEMES.get(url.scheme)
    if factory is None:
        raise ValueError(f"unknown store scheme {url.scheme!r}; registered: "
                         f"{registered_schemes()}")
    store = factory(url, **params)
    _record_uri(store, uri)
    return store


def _record_uri(store, uri: str) -> None:
    """Best-effort provenance stamp: a URI-opened store remembers its URI
    so it can be *re-opened in another process* (``store_spec``).  Stores
    with ``__slots__``/immutable instances simply stay unstamped."""
    try:
        store.uri = uri
    except (AttributeError, TypeError):  # pragma: no cover - exotic stores
        pass


def store_spec(store):
    """Picklable recipe to reconstruct ``store`` in a worker process.

    The multi-process shard driver gives every worker its own store
    instance (per-process file handles / connections, per-process
    capability negotiation) instead of sharing one across the fork:

    * a URI string travels as ``("uri", uri)`` — the worker calls
      ``open_store`` afresh, re-negotiating capabilities against its own
      instance; a store *object* does so only when its class opts in
      with ``reopen_by_uri = True`` (``LocalFSStore``: the whole state
      derives from the walked directory, so a re-open is faithful —
      unlike e.g. a ``RemoteStore`` whose datasets were registered after
      opening, which must travel as the object itself);
    * anything else travels as ``("object", store)`` — verbatim under a
      ``fork`` start method (the child inherits the parent's heap), by
      pickle under ``spawn`` (the store must then be picklable).
    """
    if isinstance(store, str):
        return ("uri", store)
    uri = getattr(store, "uri", None)
    if isinstance(uri, str) and getattr(store, "reopen_by_uri", False):
        return ("uri", uri)
    return ("object", store)


def resolve_store_spec(spec, **overrides):
    """Worker-side inverse of :func:`store_spec`."""
    kind, payload = spec
    if kind == "uri":
        return open_store(payload, **overrides)
    if kind == "object":
        return payload
    raise ValueError(f"unknown store spec kind {kind!r}")


def _mem_factory(url, **params):
    return MemStore(**params)


register_scheme("mem", _mem_factory)


# ---------------------------------------------------------------------------
# deterministic content synthesis (shared with the simulated store)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def path_seed(path: PathT) -> int:
    """64-bit content seed for a file path (blake2b of the joined path)."""
    return int.from_bytes(
        hashlib.blake2b("/".join(path).encode(),
                        digest_size=8).digest(), "little")


def synth_range(seed: int, offset: int, length: int) -> np.ndarray:
    """Deterministic pseudo-random bytes ``[offset, offset+length)`` of
    the infinite stream keyed by ``seed`` (vectorized splitmix64 over the
    64-bit word counter).  Counter-based, so any sub-range can be
    synthesized directly — ``synth_range(s, o, n)`` equals
    ``synth_range(s, 0, o+n)[o:]`` without generating the prefix."""
    if length <= 0:
        return np.empty(0, dtype=np.uint8)
    w0, w1 = offset >> 3, (offset + length - 1) >> 3
    x = (np.arange(w0, w1 + 1, dtype=np.uint64)
         + np.uint64(seed & _MASK64)) * np.uint64(_GOLDEN)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    if not x.dtype.isnative or x.dtype.byteorder == ">":  # pragma: no cover
        x = x.astype("<u8")
    raw = x.view(np.uint8)
    start = offset - (w0 << 3)
    return raw[start:start + length]
