"""``CacheDaemon``: the cache runtime as a network service.

One daemon process owns the whole caching stack — a ``CacheClient``
over either the in-process sharded engine or the supervised
multi-process driver (``open_cache`` builds it; every knob passes
through) — and serves any number of independent client processes over
a Unix-domain socket (default) or TCP.  This is the Hoard deployment
shape (arXiv:1812.00669): a per-node cache daemon with thin clients,
so many trainer/serving processes share one unified cache and one
store-metadata view instead of each re-materializing its own.

Protocol: framed pickles (``daemon.wire``), request shapes lifted from
the process driver's worker pipes, read replies in the shared compact codec
(``core.wire``).  Payload bytes for same-node clients cross a
daemon-owned ``ShmArena`` (descriptors on the wire, bytes in shared
memory, slots recycled via piggybacked frees); remote/TCP clients get
the bytes streamed inline, and arena exhaustion spills to inline too
(counted, like the process driver's spill path).

Sessions and leases: every connection is a session with an id and a
heartbeat lease.  *Any* frame renews the lease; a silent client (died
with the socket held open, wedged, live-migrated away) is reaped when
the lease expires.  Reclamation is the fault-of-the-client story
(docs/RELIABILITY.md): the session's live arena slots return to the
free list, its recently issued prefetch candidates are cancelled on
the kernel (bounded window, idempotent — a candidate the executor
already completed is a no-op), and the executor conservation identity
``submitted == completed + cancelled + deduped`` is untouched because
cancellation happens kernel-side, never by dropping executor work.  A
client that dies hard enough to close its socket (process exit) takes
the faster EOF path to the same reclaim.
"""
from __future__ import annotations

import os
import socket
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from ..core.client import CacheClient, open_cache
from ..core.procdriver import ShmArena, _RegionAllocator
from ..core.types import MB
from ..core.wire import encode_outcome
from .journal import CacheJournal
from .uri import DaemonAddress, format_cache_uri
from .wire import (ConnectionClosed, PROTO_VERSION, ProtocolError, recv_msg,
                   send_msg)

__all__ = ["CacheDaemon", "DEFAULT_LEASE_S", "DEFAULT_SNAPSHOT_EVERY_S"]

DEFAULT_LEASE_S = 5.0
DEFAULT_DAEMON_ARENA = 16 * MB
# per-session bound on remembered prefetch candidates (reclaim window)
CANDIDATE_WINDOW = 4096
# journal snapshot cadence (journal_dir configured; reaper-thread driven)
DEFAULT_SNAPSHOT_EVERY_S = 2.0


def _pending_count(engine) -> int:
    """Kernel pending-prefetch table size across any engine flavor."""
    fn = getattr(engine, "pending_prefetch_count", None)
    if callable(fn):
        return fn()
    shards = getattr(engine, "shards", None)
    if shards is not None:
        return sum(len(s._pending_prefetch) for s in shards)
    return len(engine._pending_prefetch)


class _Session:
    """One connected client: lease deadline, live arena slots, and the
    bounded window of prefetch candidates its reads triggered."""

    __slots__ = ("sid", "conn", "label", "pid", "use_shm", "deadline",
                 "live", "candidates", "reclaimed", "graceful", "send_lock")

    def __init__(self, sid: int, conn, label: str, pid: Optional[int],
                 use_shm: bool, deadline: float) -> None:
        self.sid = sid
        self.conn = conn
        self.label = label
        self.pid = pid
        self.use_shm = use_shm
        self.deadline = deadline
        self.live: Dict[int, int] = {}            # arena offset -> length
        self.candidates: "OrderedDict" = OrderedDict()
        self.reclaimed = False
        self.graceful = False
        # serializes frames onto this connection: the serve thread's
        # replies vs the drain path's out-of-band going_down notice
        self.send_lock = threading.Lock()


class CacheDaemon:
    """Network front end over one ``CacheClient``.

    ``store``/``capacity`` plus ``**open_cache_kw`` build the inner
    client exactly like :func:`~repro_torch.core.client.open_cache` would
    (``driver="process"`` puts the supervised shard workers behind the
    daemon); alternatively pass a pre-built client as ``store``.
    ``uds`` names the listening socket path (a private temp path is
    created when neither ``uds`` nor ``host`` is given); ``host``/
    ``port`` select TCP instead.

    ``lease_s`` is the session lease: a client that sends nothing (not
    even a heartbeat) for this long is presumed dead and reclaimed.
    ``arena_bytes`` sizes the shared-memory payload arena for same-node
    clients (0 disables it — all payloads stream inline).

    ``journal_dir`` makes the daemon crash-consistent (see
    ``daemon.journal``): sticky pins/bans are journaled synchronously,
    the engine's warm-restart manifest (CMU roots/quotas, resident
    keys, placement verdicts) is snapshotted every
    ``snapshot_every_s``, and a daemon constructed over the same
    directory **warm-starts** — pins replayed, verdicts re-pushed, hot
    blocks re-admitted (``restore_stats``), while a tiered store
    re-indexes its spill files independently.  ``install_sigterm=True``
    registers a SIGTERM handler that runs :meth:`drain` (graceful
    stop-accept → notify → flush → final snapshot → close); default off
    so embedding processes keep their own signal disposition.
    """

    def __init__(self, store=None, capacity: Optional[int] = None, *,
                 uds: Optional[str] = None,
                 host: Optional[str] = None, port: int = 0,
                 lease_s: float = DEFAULT_LEASE_S,
                 arena_bytes: int = DEFAULT_DAEMON_ARENA,
                 candidate_window: int = CANDIDATE_WINDOW,
                 backlog: int = 16,
                 journal_dir: Optional[str] = None,
                 snapshot_every_s: float = DEFAULT_SNAPSHOT_EVERY_S,
                 journal_fsync: bool = False,
                 install_sigterm: bool = False,
                 **open_cache_kw) -> None:
        if isinstance(store, CacheClient):
            if capacity is not None or open_cache_kw:
                raise ValueError("pass either a CacheClient or "
                                 "(store, capacity, **open_cache_kw)")
            self.client = store
        else:
            if capacity is None:
                raise ValueError("CacheDaemon needs (store, capacity) "
                                 "or a pre-built CacheClient")
            self.client = open_cache(store, capacity, **open_cache_kw)
        self.lease_s = float(lease_s)
        # ---- durable state (crash consistency)
        self.journal: Optional[CacheJournal] = None
        self.restore_stats: dict = {"mode": "none"}
        self._snapshot_every = float(snapshot_every_s)
        self._last_snapshot = time.monotonic()
        self._sticky_pins: "OrderedDict" = OrderedDict()
        self._sticky_bans: "OrderedDict" = OrderedDict()
        if journal_dir is not None:
            self.journal = CacheJournal(journal_dir, fsync=journal_fsync)
            self.restore_stats = self._restore(self.journal)
        self._candidate_window = candidate_window
        self._block_size = self.client.cfg.block_size
        self._arena = ShmArena(arena_bytes, 1) if arena_bytes > 0 else None
        if self._arena is not None and self._arena.shm is not None:
            self._alloc: Optional[_RegionAllocator] = \
                _RegionAllocator(*self._arena.region(0))
            self._arena_total = self._arena.region(0)[1]
        else:
            self._arena, self._alloc, self._arena_total = None, None, 0
        self._alloc_lock = threading.Lock()
        self._lock = threading.Lock()
        self._sessions: Dict[int, _Session] = {}
        self._next_sid = 0
        self._spills = 0
        self._reaped = 0
        self._disconnects = 0
        self._byes = 0
        self._served = 0
        self._cancelled_candidates = 0
        self._closing = False
        self._draining = False
        self._crashed = False
        self._started = False
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._tmpdir: Optional[str] = None
        # ---- listening endpoint
        if host is not None:
            self._listener = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            self._listener.bind((host, port))
            bound_host, bound_port = self._listener.getsockname()[:2]
            self.address = DaemonAddress("tcp", host=bound_host,
                                         port=bound_port)
            self._uds_path = None
        else:
            if uds is None:
                self._tmpdir = tempfile.mkdtemp(prefix="igt-daemon-")
                uds = os.path.join(self._tmpdir, "cache.sock")
            uds = str(uds)
            if os.path.exists(uds):
                os.unlink(uds)
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(uds)
            self._uds_path = uds
            self.address = DaemonAddress("uds", path=uds)
        self._listener.listen(backlog)
        if install_sigterm:
            import signal as _signal
            try:
                _signal.signal(
                    _signal.SIGTERM,
                    lambda *_a: threading.Thread(
                        target=self.drain, name="igt-daemon-drain",
                        daemon=True).start())
            except ValueError:  # pragma: no cover - not the main thread
                pass

    # -------------------------------------------------- durable state
    def _restore(self, journal: CacheJournal) -> dict:
        """Warm-start from the journal directory: fold the snapshot and
        the replayed records into one manifest, then re-admit it into
        the (fresh) engine.  Engines without ``warm_admit`` (the
        process driver keeps kernel state worker-side) still get the
        sticky pins/bans replayed — the documented degradation."""
        t0 = time.monotonic()
        snap, records = journal.load()
        state = dict(snap or {})
        pins = {tuple(p) for p in state.get("pins", ())}
        bans = {tuple(p) for p in state.get("never_cache", ())}
        verdicts = dict(state.get("verdicts") or {})
        for rec in records:
            if not rec:
                continue
            if rec[0] == "pin":
                pins.add(tuple(rec[1]))
            elif rec[0] == "never_cache":
                bans.add(tuple(rec[1]))
            elif rec[0] == "verdict":
                verdicts[str(rec[1])] = (rec[2], bool(rec[3]))
        state["pins"] = sorted(pins)
        state["never_cache"] = sorted(bans)
        state["verdicts"] = verdicts
        for p in state["pins"]:
            self._sticky_pins[p] = None
        for p in state["never_cache"]:
            self._sticky_bans[p] = None
        out = {"snapshot": snap is not None, "records": len(records),
               "mode": "cold"}
        warm = getattr(self.client.engine, "warm_admit", None)
        if snap is None and not records:
            pass                            # nothing durable yet: cold
        elif callable(warm):
            out.update(warm(state, time.monotonic()))
            out["mode"] = "warm"
        else:
            for p in state["pins"]:
                self.client.pin(p)
            for p in state["never_cache"]:
                self.client.never_cache(p)
            out["mode"] = "sticky-only"
        out["restore_s"] = time.monotonic() - t0
        return out

    def _journal_record(self, record) -> None:
        if self.journal is None:
            return
        try:
            self.journal.append(record)
        except OSError:  # pragma: no cover - sick journal disk
            pass

    def write_snapshot(self) -> bool:
        """Snapshot the engine's warm-restart manifest (+ the sticky
        sets the daemon itself tracked) into the journal, resetting the
        log.  Returns False when no journal is configured."""
        if self.journal is None:
            return False
        ws = getattr(self.client.engine, "warm_state", None)
        state = ws() if callable(ws) else {}
        with self._lock:
            pins = {tuple(p) for p in state.get("pins", ())}
            pins.update(self._sticky_pins)
            bans = {tuple(p) for p in state.get("never_cache", ())}
            bans.update(self._sticky_bans)
        state["pins"] = sorted(pins)
        state["never_cache"] = sorted(bans)
        self.journal.write_snapshot(state)
        return True

    # ----------------------------------------------------------- lifecycle
    @property
    def uri(self) -> str:
        """``cache://`` URI clients hand to ``open_cache``."""
        return format_cache_uri(self.address)

    def start(self) -> "CacheDaemon":
        if self._started:
            return self
        self._started = True
        acc = threading.Thread(target=self._accept_loop,
                               name="igt-daemon-accept", daemon=True)
        reap = threading.Thread(target=self._reap_loop,
                                name="igt-daemon-reaper", daemon=True)
        self._threads += [acc, reap]
        acc.start()
        reap.start()
        return self

    def drain(self, timeout: float = 10.0) -> None:
        """Graceful shutdown (the SIGTERM path): stop accepting, tell
        every live session the daemon is ``going_down`` (an out-of-band
        status frame — the client marks the connection down instead of
        diagnosing a crash from EOF), flush in-flight prefetches, write
        a final snapshot, then close.  Idempotent."""
        with self._lock:
            if self._draining or self._closing:
                return
            self._draining = True
        try:
            self._listener.close()
        except OSError:  # pragma: no cover
            pass
        for sess in list(self._sessions.values()):
            try:
                if sess.send_lock.acquire(timeout=1.0):
                    try:
                        send_msg(sess.conn, ("going_down", None))
                    finally:
                        sess.send_lock.release()
            except (ConnectionError, OSError):
                pass                        # that client is already gone
        try:
            self.client.flush(timeout=timeout)
        except Exception:  # pragma: no cover - flush is best-effort here
            pass
        try:
            self.write_snapshot()
        except Exception:  # pragma: no cover - sick journal disk
            pass
        self.close()

    def crash(self) -> None:
        """Abrupt death for drills (the in-process stand-in for
        ``SIGKILL``): every socket is closed mid-conversation — no
        ``going_down``, no flush, **no final snapshot** (recovery must
        work from the journal's last periodic snapshot + log) — and the
        stale UDS socket path is deliberately left behind so the
        respawn exercises the bind-over-stale-path race.  The engine is
        still closed (it lives in *this* process; leaking its executor
        threads would poison the test process), but only after the
        sockets are dead, mirroring the ordering a real kill gives
        clients."""
        with self._lock:
            if self._closing:
                return
            self._crashed = True
            self._closing = True
        self._stop.set()
        try:
            self._listener.close()
        except OSError:  # pragma: no cover
            pass
        for sess in list(self._sessions.values()):
            try:
                sess.conn.close()
            except OSError:  # pragma: no cover
                pass
        if self.journal is not None:
            self.journal.close()
        try:
            self.client.close()
        except Exception:  # pragma: no cover - already half-dead
            pass
        if self._arena is not None:
            self._arena.close()
        # NOTE: self._uds_path is NOT unlinked — the stale socket stays.

    def close(self) -> None:
        if self._closing:
            return
        self._closing = True
        self._stop.set()
        try:
            self._listener.close()
        except OSError:  # pragma: no cover
            pass
        for sess in list(self._sessions.values()):
            self._reclaim(sess, "shutdown")
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        try:
            self.client.flush(timeout=10.0)
        except Exception:  # pragma: no cover - flush is best-effort here
            pass
        if self.journal is not None:
            try:
                self.write_snapshot()
            except Exception:  # pragma: no cover - sick journal disk
                pass
            self.journal.close()
        self.client.close()
        if self._arena is not None:
            self._arena.close()
        if self._uds_path is not None and os.path.exists(self._uds_path):
            try:
                os.unlink(self._uds_path)
            except OSError:  # pragma: no cover
                pass
        if self._tmpdir is not None:
            try:
                os.rmdir(self._tmpdir)
            except OSError:  # pragma: no cover - stray files
                pass

    def __enter__(self) -> "CacheDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------- accept/serve
    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                      # listener closed: shutting down
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="igt-daemon-conn", daemon=True)
            self._threads.append(t)
            t.start()

    def _serve_conn(self, conn) -> None:
        sess: Optional[_Session] = None
        try:
            op, _, payload = recv_msg(conn)
            if op != "hello" or payload.get("proto") != PROTO_VERSION:
                send_msg(conn, ("err", ProtocolError(
                    f"handshake must be a v{PROTO_VERSION} hello")))
                return
            use_shm = (self._alloc is not None
                       and self.address.kind == "uds"
                       and bool(payload.get("shm", True)))
            with self._lock:
                if self._closing:
                    return
                sid = self._next_sid
                self._next_sid += 1
                sess = _Session(sid, conn, payload.get("label") or f"s{sid}",
                                payload.get("pid"), use_shm,
                                time.monotonic() + self.lease_s)
                self._sessions[sid] = sess
            with sess.send_lock:
                send_msg(conn, ("ok", {
                    "proto": PROTO_VERSION,
                    "session": sid,
                    "lease_s": self.lease_s,
                    "block_size": self._block_size,
                    "shm": self._arena.name if use_shm else None,
                    "server_pid": os.getpid(),
                }))
            while True:
                op, frees, payload = recv_msg(conn)
                sess.deadline = time.monotonic() + self.lease_s
                if frees:
                    self._apply_frees(sess, frees)
                if op == "bye":
                    sess.graceful = True
                    with sess.send_lock:
                        send_msg(conn, ("ok", None))
                    return
                try:
                    result = self._dispatch(sess, op, payload)
                except BaseException as e:
                    try:
                        with sess.send_lock:
                            send_msg(conn, ("err", e))
                    except (ConnectionError, OSError):
                        raise
                    except Exception:   # unpicklable: degrade to repr
                        with sess.send_lock:
                            send_msg(conn, ("err", RuntimeError(repr(e))))
                    continue
                with sess.send_lock:
                    send_msg(conn, ("ok", result))
        except (ConnectionClosed, ConnectionError, OSError, EOFError,
                ProtocolError):
            pass                            # peer died: reclaim below
        finally:
            if sess is not None:
                self._reclaim(sess, "bye" if sess.graceful
                              else "disconnect")
            else:
                try:
                    conn.close()
                except OSError:  # pragma: no cover
                    pass

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, sess: _Session, op: str, payload):
        c = self.client
        if op == "read_batch":
            reqs, now, want = payload
            return self._serve_reads(sess, reqs,
                                     c.read_batch(reqs, now,
                                                  fetch=bool(want)),
                                     want)
        if op == "read":
            fp, off, size, now, want = payload
            res = c.read(fp, off, size, now, fetch=bool(want))
            encs, payloads = self._serve_reads(sess, [(fp, off, size)],
                                               [res], want)
            return encs[0], payloads[0]
        if op == "heartbeat":
            return {"t": time.monotonic(), "session": sess.sid}
        if op == "stats":
            return c.stats
        if op == "snapshot":
            return c.snapshot()
        if op == "hit_ratio":
            return c.hit_ratio()
        if op == "fault_stats":
            return c.fault_stats()
        if op == "shard_states":
            return c.shard_states()
        if op == "tick":
            c.tick(payload)
            return None
        if op == "pin":
            c.pin(payload)
            key = tuple(payload)
            with self._lock:
                self._sticky_pins[key] = None
            self._journal_record(("pin", key))
            return None
        if op == "never_cache":
            c.never_cache(payload)
            key = tuple(payload)
            with self._lock:
                self._sticky_bans[key] = None
            self._journal_record(("never_cache", key))
            return None
        if op == "flush":
            return c.flush(payload)
        if op == "daemon_stats":
            return self.daemon_stats()
        if op == "file_size":
            return c.meta.file_size(payload)
        if op == "subtree_bytes":
            return c.meta.subtree_bytes(payload)
        raise ValueError(f"unknown daemon op {op!r}")

    def _serve_reads(self, sess: _Session, reqs, results, want):
        bs = self._block_size
        encs, payloads = [], []
        for (fp, off, _sz), res in zip(reqs, results):
            self._note_candidates(sess, res.outcome.prefetches)
            encs.append(encode_outcome(res.outcome, off // bs))
            payloads.append(self._stage(sess, res.data) if want else None)
        with self._lock:
            self._served += len(reqs)
        return encs, payloads

    def _note_candidates(self, sess: _Session, prefetches) -> None:
        if not prefetches:
            return
        cands = sess.candidates
        for p, _s in prefetches:
            cands[p] = None
            cands.move_to_end(p)
        while len(cands) > self._candidate_window:
            cands.popitem(last=False)

    def _stage(self, sess: _Session, data):
        """Payload placement: arena slot descriptor for same-node
        sessions, inline bytes otherwise (and on arena exhaustion —
        counted as a spill, like the process driver)."""
        if data is None:
            return None
        arr = np.asarray(data, dtype=np.uint8)
        n = int(arr.size)
        if n == 0:
            return ("raw", b"")
        if sess.use_shm:
            with self._alloc_lock:
                off = self._alloc.alloc(n)
                if off >= 0:
                    sess.live[off] = n
            if off >= 0:
                dst = np.frombuffer(self._arena.shm.buf, dtype=np.uint8,
                                    count=n, offset=off)
                dst[:] = arr
                return ("shm", off, n)
            with self._lock:
                self._spills += 1
        return ("raw", arr.tobytes())

    # ----------------------------------------------------------- reclaim
    def _apply_frees(self, sess: _Session, frees) -> None:
        with self._alloc_lock:
            for off, n in frees:
                if sess.live.pop(off, None) == n:
                    self._alloc.free(off, n)

    def _reclaim(self, sess: _Session, reason: str) -> None:
        """Session teardown — idempotent, reached from the serve thread
        (EOF / bye), the reaper (lease expiry), and ``close``.  Frees
        every arena slot the client still held and cancels its window of
        prefetch candidates on the kernel (clearing pending-table
        entries so re-issue is never suppressed; an already-completed
        candidate is a no-op)."""
        with self._lock:
            if sess.reclaimed:
                return
            sess.reclaimed = True
            self._sessions.pop(sess.sid, None)
            if reason == "lease":
                self._reaped += 1
            elif reason == "disconnect":
                self._disconnects += 1
            elif reason == "bye":
                self._byes += 1
        try:
            sess.conn.close()
        except OSError:  # pragma: no cover
            pass
        with self._alloc_lock:
            for off, n in sess.live.items():
                self._alloc.free(off, n)
            sess.live.clear()
        cancelled = 0
        for path in list(sess.candidates):
            try:
                self.client.cancel_prefetch(path)
                cancelled += 1
            except Exception:  # pragma: no cover - engine shutting down
                break
        sess.candidates.clear()
        with self._lock:
            self._cancelled_candidates += cancelled

    def _reap_loop(self) -> None:
        tick = max(0.05, min(0.25, self.lease_s / 4.0))
        while not self._stop.wait(tick):
            now = time.monotonic()
            for sess in list(self._sessions.values()):
                if now > sess.deadline:
                    self._reclaim(sess, "lease")
            if (self.journal is not None and not self._draining
                    and now - self._last_snapshot >= self._snapshot_every):
                self._last_snapshot = now
                try:
                    self.write_snapshot()
                except Exception:  # pragma: no cover - sick journal disk
                    pass

    # ------------------------------------------------------------- stats
    def daemon_stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
            out = {
                "sessions": len(sessions),
                "served_reads": self._served,
                "spills": self._spills,
                "reaped": self._reaped,
                "disconnects": self._disconnects,
                "byes": self._byes,
                "cancelled_candidates": self._cancelled_candidates,
                "draining": self._draining,
                "crashed": self._crashed,
                "restore": dict(self.restore_stats),
                "journal": (self.journal.stats.snapshot()
                            if self.journal is not None else None),
            }
        with self._alloc_lock:
            out["arena_total"] = self._arena_total
            out["arena_free"] = (self._alloc.free_bytes()
                                 if self._alloc is not None else 0)
            out["live_slots"] = sum(len(s.live) for s in sessions)
        out["pending_prefetch"] = _pending_count(self.client.engine)
        return out
