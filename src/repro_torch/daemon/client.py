"""``RemoteCacheClient``: the thin client for a ``CacheDaemon``.

Satisfies the ``CacheClient`` read surface — ``read`` / ``read_batch``
returning ``ReadResult`` objects (outcomes are ``core.wire.WireOutcome``
views decoded lazily from the shared compact codec), plus the stats
family (``stats`` / ``snapshot`` / ``hit_ratio`` / ``fault_stats``) and
the kernel passthroughs (``tick`` / ``pin`` / ``never_cache`` /
``flush``) — but holds no kernel, no store, and no executor: every call
is one framed request to the daemon.  ``open_cache("cache://...")``
constructs one.

Payload bytes: when the daemon granted shared-memory payloads (hello
reply carries the arena name — same-node, UDS), ``("shm", off, n)``
descriptors are copied out of the mapped arena and the slot is queued
for release, piggybacked on the next request (no free ever needs its
own round trip).  ``("raw", bytes)`` descriptors (TCP, arena spills)
are wrapped zero-copy.

Surviving the daemon (docs/RELIABILITY.md "Fault of the
daemon"): the connection is a state machine — ``up`` / ``down`` /
``closed``.  Any wire failure (EOF from a crash, an RPC timeout, the
drain path's out-of-band ``going_down`` frame) marks the connection
``down``, *wakes any blocked caller* (the socket carries a
``rpc_timeout_s`` deadline, so no call ever hangs on a dead daemon),
and hands the management thread to a bounded-exponential-backoff
reconnector.  Reconnection is a fresh session: stale arena frees are
dropped (the old daemon's lease reclaim owns those slots), the shm
arena is remapped from the new hello, and the locally tracked sticky
``pin`` / ``never_cache`` prefixes are replayed — belt-and-braces over
the daemon's own journal replay, and the only path for daemons running
without one.

While ``down``, ``degraded=True`` (the default, requires a ``backing=``
store for byte reads) serves reads straight from the backing store —
all-miss outcomes from store geometry, bytes via ``fetch_many``,
counted in ``client_stats`` exactly like the shard-level degraded
path.  ``degraded=False`` raises the typed
:class:`~repro_torch.core.faults.DaemonUnavailableError` instead.  Operations
that *need* the daemon (stats, snapshots) always raise it while down;
``flush`` short-circuits to ``False``; ``tick`` becomes a no-op (the
kernel it would advance is gone — the restarted daemon re-learns).

Liveness: one background management thread renews the session lease at
a third of the daemon's ``lease_s`` (skipping the renewal when a caller
holds the wire — their frame renews the lease anyway) and runs the
reconnector while down.  A failed heartbeat marks the connection dead
and closes the socket so blocked callers wake with the typed error —
it never silently exits with callers still parked.  ``close()`` says
goodbye and releases the session immediately; ``kill()`` exists for
fault drills — it silences the client (and optionally drops the
socket) exactly like a crashed process would, so tests and the chaos
harness can watch the daemon's lease reclaim run.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.cache import path_key
from ..core.client import ClientStats, ReadResult
from ..core.faults import DaemonUnavailableError
from ..core.igtcache import BlockResult, ReadOutcome
from ..core.types import PathT, block_key
from ..core.wire import WireOutcome
from ..storage.api import as_backing_store
from .uri import DaemonAddress, parse_cache_uri
from .wire import PROTO_VERSION, recv_msg, send_msg

__all__ = ["RemoteCacheClient"]


class _RemoteMeta:
    """``StoreMeta`` over the wire: the daemon answers from its store,
    so remote callers can size reads (``client.meta.file_size(path)``)
    without a local copy of the dataset layout.  Answers are memoized
    client-side so degraded reads keep exact file geometry while the
    daemon is away; a ``backing=`` store fills unmemoized holes."""

    __slots__ = ("_client",)

    def __init__(self, client: "RemoteCacheClient") -> None:
        self._client = client

    def file_size(self, path: PathT) -> int:
        c = self._client
        try:
            size = int(c._request("file_size", path))
        except DaemonUnavailableError:
            if not c.degraded:
                raise
            return c._file_size_fallback(path)
        c._fsize_memo[path_key(path)] = size
        return size

    def subtree_bytes(self, path: PathT) -> int:
        c = self._client
        try:
            return c._request("subtree_bytes", path)
        except DaemonUnavailableError:
            if not c.degraded:
                raise
            fn = getattr(c._backing, "subtree_bytes", None)
            if callable(fn):
                return fn(path)
            raise


class RemoteCacheClient:
    """One session against a :class:`~repro_torch.daemon.CacheDaemon`.

    ``target`` is a ``cache://`` URI or a :class:`DaemonAddress`.
    ``fetch_bytes`` mirrors ``CacheClient``: the default for per-call
    ``fetch``.  ``now`` semantics also mirror the local client, with one
    twist: omitted timestamps are stamped *by the daemon* — every
    client of one daemon then shares a single coherent kernel timeline
    instead of mixing per-process monotonic epochs.  Virtual-clock
    callers pass ``now`` explicitly, which travels verbatim.

    Resilience knobs (URI query params or kwargs): ``reconnect``
    re-establishes a dead session with bounded exponential backoff
    (capped at ``max_backoff_s``); ``degraded`` serves reads from the
    ``backing=`` store while the daemon is down instead of raising
    :class:`DaemonUnavailableError`; ``rpc_timeout_s`` bounds every
    wire wait so a dead-but-connected daemon can never hang a caller
    (``None`` restores the old block-forever behavior).
    """

    # simulators and other harnesses dispatch on this instead of
    # importing the class (daemon package stays optional at sim time)
    is_remote_cache_client = True

    def __init__(self, target, *,
                 fetch_bytes: bool = False,
                 label: Optional[str] = None,
                 heartbeat: bool = True,
                 shm: bool = True,
                 connect_timeout: float = 10.0,
                 reconnect: bool = True,
                 degraded: bool = True,
                 max_backoff_s: float = 2.0,
                 rpc_timeout_s: Optional[float] = 30.0,
                 backing=None) -> None:
        address = (target if isinstance(target, DaemonAddress)
                   else parse_cache_uri(str(target)))
        self.address = address
        self.fetch_bytes = fetch_bytes
        self.degraded = bool(degraded)
        self.reconnect = bool(reconnect)
        self.max_backoff_s = float(max_backoff_s)
        self.rpc_timeout_s = (None if rpc_timeout_s is None
                              else float(rpc_timeout_s))
        self.connect_timeout = float(connect_timeout)
        self._label = label
        self._want_shm = bool(shm)
        self._backing = as_backing_store(backing)
        self._lock = threading.RLock()
        self._pending_frees: List[Tuple[int, int]] = []
        self._closed = False
        self._killed = False
        self._zombie = None          # kill(): keeps the socket fd open
        self.state = "down"
        self.reconnects = 0
        self.disconnects = 0
        self.client_stats = ClientStats()
        self._cstats_lock = threading.Lock()
        # sticky controls, replayed into a fresh session on reconnect
        self._pins: Dict[tuple, None] = {}
        self._bans: Dict[tuple, None] = {}
        self._fsize_memo: Dict[tuple, int] = {}
        self._sock = None
        self._shm = None
        self._connect_session()          # raises if the first dial fails
        self.meta = _RemoteMeta(self)
        self._stop = threading.Event()
        self._hb_enabled = bool(heartbeat)
        self._mgmt_thread = None
        if self._hb_enabled or self.reconnect:
            self._mgmt_thread = threading.Thread(
                target=self._mgmt_loop, daemon=True,
                name=f"igt-daemon-client-{self.session_id}")
            self._mgmt_thread.start()

    # --------------------------------------------------------------- wire
    def _connect_session(self) -> None:
        """Dial + handshake one fresh session (first connect and every
        reconnect).  Caller holds ``self._lock`` on the reconnect path.
        On success the socket carries the RPC deadline, the shm arena is
        (re)mapped from the hello, and stale frees are dropped."""
        import socket as _socket
        kind, addr = self.address.connect_args()
        fam = _socket.AF_UNIX if kind == "uds" else _socket.AF_INET
        sock = _socket.socket(fam, _socket.SOCK_STREAM)
        sock.settimeout(self.connect_timeout)
        try:
            sock.connect(addr)
            sock.settimeout(self.rpc_timeout_s)
            send_msg(sock, ("hello", (), {
                "proto": PROTO_VERSION,
                "pid": os.getpid(),
                "label": self._label,
                "shm": self._want_shm,
            }))
            status, info = recv_msg(sock)
        except BaseException:
            sock.close()
            raise
        if status != "ok":
            sock.close()
            if isinstance(info, BaseException):
                raise info
            raise ConnectionError(f"daemon refused session: {info!r}")
        self._sock = sock
        self.session_id = info["session"]
        self.lease_s = info["lease_s"]
        self.block_size = info["block_size"]
        self._release_shm()
        if info.get("shm"):
            from multiprocessing import shared_memory
            self._shm = shared_memory.SharedMemory(name=info["shm"])
        # frees queued for the *old* session are stale: that daemon's
        # lease reclaim (or its death) already returned the slots
        self._pending_frees = []
        self.state = "up"

    def _mark_down(self, reason: str) -> None:
        """Declare the connection dead: close the socket (waking any
        caller blocked in ``recv``), drop stale frees, release the shm
        mapping, and hand the connection to the reconnector."""
        with self._lock:
            if self._closed or self._killed or self.state != "up":
                return
            self.state = "down"
            self.disconnects += 1
            self._pending_frees = []
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:  # pragma: no cover
                    pass
            self._release_shm()

    def _request(self, op: str, payload=None, *,
                 timeout: Optional[float] = None):
        with self._lock:
            if self._killed:
                raise ConnectionError("remote cache client is killed")
            if self._closed:
                raise DaemonUnavailableError(
                    "remote cache client is closed", state="closed")
            if self.state != "up":
                raise DaemonUnavailableError(
                    f"cache daemon at {self.address.display} is "
                    f"unavailable (op={op!r})", state=self.state)
            frees, self._pending_frees = self._pending_frees, []
            try:
                if timeout is not None:
                    self._sock.settimeout(timeout)
                send_msg(self._sock, (op, frees, payload))
                status, result = recv_msg(self._sock)
            except (ConnectionError, OSError, EOFError) as e:
                # covers socket.timeout (OSError): the deadline is the
                # no-hung-callers guarantee, treated as a dead daemon
                self._mark_down(f"{op}: {e!r}")
                raise DaemonUnavailableError(
                    f"cache daemon at {self.address.display} died "
                    f"mid-{op}: {e!r}", state="down") from e
            finally:
                if timeout is not None and self.state == "up":
                    try:
                        self._sock.settimeout(self.rpc_timeout_s)
                    except OSError:  # pragma: no cover
                        pass
            if status == "going_down":
                # drain notice (SIGTERM path): the daemon flushed and
                # snapshotted; reconnect when its successor binds
                self._mark_down("daemon draining")
                raise DaemonUnavailableError(
                    f"cache daemon at {self.address.display} is "
                    f"draining", state="down")
        if status == "err":
            raise result
        return result

    # ------------------------------------------------- management thread
    def _mgmt_loop(self) -> None:
        """One thread, two duties: lease renewal while ``up``,
        backoff-paced redial while ``down``."""
        hb_wait = max(0.05, float(self.lease_s) / 3.0)
        backoff = 0.05
        while not self._stop.is_set():
            if self._closed or self._killed:
                return
            if self.state == "up":
                backoff = 0.05
                if self._stop.wait(hb_wait if self._hb_enabled else 0.1):
                    return
                if self._hb_enabled and self.state == "up":
                    self._try_heartbeat()
            else:
                if not self.reconnect:
                    return              # stays down until close()
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2.0, self.max_backoff_s)
                self._try_reconnect()

    def _try_heartbeat(self) -> None:
        """Lease renewal that never queues behind a blocked caller: if
        someone holds the wire their own frame renews the lease; if the
        wire is free and the heartbeat fails, ``_request`` marks the
        connection down (closing the socket) — the old behavior of
        silently exiting left callers parked on a dead daemon."""
        if not self._lock.acquire(blocking=False):
            return
        try:
            if self.state == "up" and not self._closed and not self._killed:
                try:
                    self._request("heartbeat")
                except (DaemonUnavailableError, ConnectionError):
                    pass                # _request already marked us down
        finally:
            self._lock.release()

    def _try_reconnect(self) -> None:
        with self._lock:
            if self._closed or self._killed or self.state != "down":
                return
            try:
                self._connect_session()
            except (ConnectionError, OSError, EOFError):
                return                  # daemon still away: next backoff
            self.reconnects += 1
            # replay sticky controls into the fresh session — idempotent
            # server-side, and the only path for journal-less daemons
            for p in list(self._pins):
                try:
                    self._request("pin", p)
                except (DaemonUnavailableError, ConnectionError):
                    return              # died again mid-replay
            for p in list(self._bans):
                try:
                    self._request("never_cache", p)
                except (DaemonUnavailableError, ConnectionError):
                    return

    # --------------------------------------------------------------- reads
    def read(self, file_path: PathT, offset: int, size: int,
             now: Optional[float] = None, *,
             fetch: Optional[bool] = None) -> ReadResult:
        want = self.fetch_bytes if fetch is None else fetch
        try:
            enc, payload = self._request(
                "read", (file_path, offset, size, now, want))
        except DaemonUnavailableError:
            if not self.degraded or self._closed:
                raise
            return self._degraded_read(file_path, offset, size, want)
        return ReadResult(WireOutcome(enc, file_path),
                          self._materialize(payload))

    def read_batch(self, requests: Sequence[Tuple[PathT, int, int]],
                   now: Optional[float] = None, *,
                   fetch: Optional[bool] = None) -> List[ReadResult]:
        want = self.fetch_bytes if fetch is None else fetch
        requests = list(requests)
        try:
            encs, payloads = self._request("read_batch",
                                           (requests, now, want))
        except DaemonUnavailableError:
            if not self.degraded or self._closed:
                raise
            return [self._degraded_read(fp, off, sz, want)
                    for fp, off, sz in requests]
        return [ReadResult(WireOutcome(enc, fp), self._materialize(pl))
                for (fp, _o, _s), enc, pl in zip(requests, encs, payloads)]

    # ------------------------------------------------------- degraded path
    def _file_size_fallback(self, path: PathT) -> int:
        key = path_key(path)
        size = self._fsize_memo.get(key)
        if size is not None:
            return size
        fn = getattr(self._backing, "file_size", None)
        if callable(fn):
            size = int(fn(path))
            self._fsize_memo[key] = size
            return size
        raise DaemonUnavailableError(
            f"no file geometry for {path!r} while the daemon is down "
            f"(unmemoized, and the backing store serves no metadata)",
            state=self.state)

    def _degraded_read(self, file_path: PathT, offset: int, size: int,
                       want: bool) -> ReadResult:
        """Serve one request without the daemon: all-miss outcome from
        store geometry (mirroring ``CacheClient._degraded_outcome``),
        bytes straight from the ``backing=`` store.  No cache
        observation happens — the restarted daemon's kernel re-learns
        this stream from its journal, not from reads it never saw."""
        bs = self.block_size
        try:
            fsize = self._file_size_fallback(file_path)
        except Exception:
            fsize = offset + size    # unknown geometry: trust the request
        end = min(offset + size, fsize)
        blocks: List[BlockResult] = []
        reqs = []
        if end > offset:
            first = offset // bs
            for b in range(first, (end - 1) // bs + 1):
                blocks.append(BlockResult(
                    path_key(block_key(file_path, b)),
                    min(bs, fsize - b * bs), False))
                start = max(offset, b * bs) - b * bs
                stop = min(end, b * bs + blocks[-1].size) - b * bs
                if stop > start:
                    reqs.append((block_key(file_path, b), start,
                                 stop - start))
        out = ReadOutcome(blocks, [])
        with self._cstats_lock:
            self.client_stats.degraded_reads += 1
        if not want or not reqs:
            return ReadResult(out)
        if self._backing is None:
            raise DaemonUnavailableError(
                "degraded byte read needs a backing= store "
                "(daemon is down and holds the only byte path)",
                state=self.state)
        data = self._backing.fetch_many(reqs)
        with self._cstats_lock:
            self.client_stats.degraded_bytes += sum(r[2] for r in reqs)
        return ReadResult(out, np.concatenate(
            [np.asarray(d, dtype=np.uint8) for d in data])
            if data else None)

    def _materialize(self, payload) -> Optional[np.ndarray]:
        if payload is None:
            return None
        kind = payload[0]
        if kind == "raw":
            return np.frombuffer(payload[1], dtype=np.uint8)
        _, off, n = payload
        view = np.frombuffer(self._shm.buf, dtype=np.uint8, count=n,
                             offset=off)
        data = view.copy()
        del view
        with self._lock:
            self._pending_frees.append((off, n))
        return data

    # -------------------------------------------------------- passthrough
    @property
    def stats(self):
        return self._request("stats")

    def hit_ratio(self) -> float:
        return self._request("hit_ratio")

    def snapshot(self) -> dict:
        return self._request("snapshot")

    def fault_stats(self) -> dict:
        return self._request("fault_stats")

    def shard_states(self):
        return self._request("shard_states")

    def daemon_stats(self) -> dict:
        return self._request("daemon_stats")

    def tick(self, now: Optional[float] = None) -> None:
        try:
            self._request("tick", now)
        except DaemonUnavailableError:
            if not self.degraded:
                raise               # the kernel this would advance is gone

    def pin(self, path: PathT) -> None:
        self._pins[tuple(path)] = None      # replayed on reconnect
        try:
            self._request("pin", path)
        except DaemonUnavailableError:
            if not self.degraded:
                raise

    def never_cache(self, path: PathT) -> None:
        self._bans[tuple(path)] = None
        try:
            self._request("never_cache", path)
        except DaemonUnavailableError:
            if not self.degraded:
                raise

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Drain the daemon's executor.  Against a dead daemon this
        short-circuits to ``False`` promptly — there is nothing left to
        drain, and blocking a shutdown path on a corpse helps no one.
        The wire deadline stretches past ``timeout`` so a *live* flush
        is never killed by the generic RPC deadline."""
        wire_to = None
        if timeout is not None and self.rpc_timeout_s is not None:
            wire_to = max(float(timeout) + 5.0, self.rpc_timeout_s)
        try:
            return self._request("flush", timeout, timeout=wire_to)
        except DaemonUnavailableError:
            return False

    def connection_stats(self) -> dict:
        """Client-side view of the connection state machine."""
        with self._lock:
            return {
                "state": "closed" if self._closed else self.state,
                "reconnects": self.reconnects,
                "disconnects": self.disconnects,
                "degraded": self.degraded,
                "client_stats": self.client_stats.snapshot(),
                "pins_tracked": len(self._pins),
                "never_cache_tracked": len(self._bans),
            }

    def heartbeat(self) -> dict:
        """Explicit lease renewal (the background thread's op)."""
        return self._request("heartbeat")

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Graceful goodbye: the daemon releases the session (and every
        arena slot it still tracks) immediately — no lease wait.
        Against a dead daemon the goodbye is skipped (nothing to tell)
        and close returns promptly instead of dialing a corpse."""
        if self._closed or self._killed:
            return
        self._stop.set()
        if self.state == "up":
            try:
                self._request("bye", timeout=2.0)
            except (DaemonUnavailableError, ConnectionError, OSError,
                    EOFError):
                pass
        with self._lock:
            self._closed = True
            self.state = "closed"
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover
                pass
        self._release_shm()
        if (self._mgmt_thread is not None
                and self._mgmt_thread is not threading.current_thread()):
            self._mgmt_thread.join(timeout=2.0)

    def kill(self, *, drop_connection: bool = False) -> None:
        """Die like a crashed client (fault drills / chaos harness).

        Default: go *silent* — heartbeats stop, the socket stays open
        but unused (the wedged-process case; only the daemon's lease
        can notice).  ``drop_connection=True`` closes the socket without
        a goodbye instead (the killed-process case; the daemon sees EOF
        and reclaims at once).  A killed client never reconnects —
        that is the point of the drill."""
        if self._closed:
            return
        self._stop.set()
        self._killed = True
        if drop_connection:
            try:
                self._sock.close()
            except OSError:  # pragma: no cover
                pass
        else:
            self._zombie = self._sock      # hold the fd: no EOF, no FIN
        self._release_shm()

    def _release_shm(self) -> None:
        if self._shm is not None:
            try:
                self._shm.close()
            except BufferError:  # pragma: no cover - live views
                pass
            self._shm = None

    def __enter__(self) -> "RemoteCacheClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
