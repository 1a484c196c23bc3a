"""Crash-consistent daemon state: append-only journal + snapshots.

The daemon's kernel is rebuildable — a cache can always re-learn — but
rebuilding is *slow*: every stream re-converges from UNKNOWN, sticky
pins are forgotten, and the tiered store's spill tier's still-valid files sit
unindexed next to a cold RAM kernel.  :class:`CacheJournal` captures
the small, high-leverage state a restarted daemon needs to warm-start:

* **sticky controls** — ``pin`` / ``never_cache`` prefixes (journaled
  synchronously as records: a pin must survive a crash that happens one
  frame later);
* **classifier verdicts** — the per-dataset ``(pattern, pin_ram)``
  placement hints the engine pushed to the tiered store;
* **a residency manifest** — the CMU roots/quotas and the RAM-resident
  block keys at snapshot time, so the new kernel re-admits its hot set
  (metadata-only: the kernel never held payload bytes, so re-admission
  is exact) while the spill tier re-indexes its own files.

Durability model (standard write-ahead shape):

* records are CRC-32-framed pickles appended to ``journal.log``; replay
  stops at EOF, a short frame, or a CRC mismatch and **truncates the
  torn tail** (a crash mid-append loses at most the record being
  written, never the prefix);
* snapshots serialize the full state into ``state.snap`` via the
  atomic tmp → ``fsync`` → ``os.replace`` dance, then reset the log —
  a crash mid-snapshot leaves the previous snapshot + full log intact
  (``os.replace`` is the commit point);
* replay is idempotent: pins/verdicts are set-valued, manifest entries
  are keyed, so re-applying a record after an earlier partial recovery
  is harmless.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from typing import Any, Iterator, List, Optional, Tuple

__all__ = ["CacheJournal", "JournalStats"]

# record frame: payload length + CRC-32 of the payload, then the pickle
_FRAME = struct.Struct("!II")
# snapshot file: magic + version header, then one framed record
_SNAP_MAGIC = b"IGTJ"
_SNAP_VERSION = 1

SNAP_NAME = "state.snap"
LOG_NAME = "journal.log"


class JournalStats:
    """Counters for one journal (recovery observability)."""

    __slots__ = ("records_appended", "snapshots", "replayed_records",
                 "truncated_bytes", "snapshot_loaded")

    def __init__(self) -> None:
        self.records_appended = 0
        self.snapshots = 0
        self.replayed_records = 0
        self.truncated_bytes = 0
        self.snapshot_loaded = False

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) \
        + payload


def _read_frames(data: bytes) -> Tuple[List[Any], int]:
    """Decode framed records from ``data``; returns (records, clean
    prefix length).  Decoding stops — without raising — at the first
    torn frame: short header, short payload, CRC mismatch, or a payload
    pickle that fails to load."""
    out: List[Any] = []
    pos = 0
    n = len(data)
    while pos + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(data, pos)
        start = pos + _FRAME.size
        end = start + length
        if end > n:
            break                              # torn tail: partial payload
        payload = data[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break                              # torn/corrupt record
        try:
            out.append(pickle.loads(payload))
        except Exception:
            break
        pos = end
    return out, pos


class CacheJournal:
    """One daemon's durable state directory (``state.snap`` +
    ``journal.log``).

    ``append(record)`` journals one event synchronously (write +
    flush); ``write_snapshot(state)`` atomically replaces the snapshot
    and resets the log; ``load()`` returns ``(snapshot_state,
    records)`` replayed from disk, truncating any torn log tail it
    finds.  Thread-safe: one lock serializes append/snapshot/load.
    """

    def __init__(self, root: str, *, fsync: bool = False) -> None:
        self.root = str(root)
        self.fsync = bool(fsync)
        os.makedirs(self.root, exist_ok=True)
        self.snap_path = os.path.join(self.root, SNAP_NAME)
        self.log_path = os.path.join(self.root, LOG_NAME)
        self.stats = JournalStats()
        self._lock = threading.Lock()
        self._log = open(self.log_path, "ab")

    # ------------------------------------------------------------- records
    def append(self, record: Any) -> None:
        """Append one journal record (framed, flushed)."""
        payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
        with self._lock:
            self._log.write(_frame(payload))
            self._log.flush()
            if self.fsync:
                os.fsync(self._log.fileno())
            self.stats.records_appended += 1

    # ----------------------------------------------------------- snapshots
    def write_snapshot(self, state: Any) -> None:
        """Atomically replace the snapshot with ``state`` and reset the
        log.  Commit point is ``os.replace`` — a crash anywhere before
        it leaves the previous snapshot + the full log; a crash after
        it but before the log reset merely replays records the new
        snapshot already contains (replay is idempotent)."""
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        blob = _SNAP_MAGIC + bytes([_SNAP_VERSION]) + _frame(payload)
        tmp = self.snap_path + f".{os.getpid()}.tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            # log reset: records up to here are folded into the snapshot
            self._log.close()
            self._log = open(self.log_path, "wb")
            self._log.flush()
            self.stats.snapshots += 1

    # --------------------------------------------------------------- load
    def load(self) -> Tuple[Optional[Any], List[Any]]:
        """Replay state from disk: ``(snapshot_state_or_None,
        journal_records)``.  A torn log tail is truncated in place; an
        unreadable snapshot degrades to ``None`` (cold start) rather
        than raising."""
        with self._lock:
            snap = self._load_snapshot()
            records = self._replay_log()
        self.stats.snapshot_loaded = snap is not None
        self.stats.replayed_records = len(records)
        return snap, records

    def _load_snapshot(self) -> Optional[Any]:
        try:
            with open(self.snap_path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        head = len(_SNAP_MAGIC) + 1
        if len(blob) < head or blob[:len(_SNAP_MAGIC)] != _SNAP_MAGIC \
                or blob[len(_SNAP_MAGIC)] != _SNAP_VERSION:
            return None
        records, _ = _read_frames(blob[head:])
        return records[0] if records else None

    def _replay_log(self) -> List[Any]:
        try:
            with open(self.log_path, "rb") as f:
                data = f.read()
        except OSError:
            return []
        records, clean = _read_frames(data)
        if clean < len(data):
            # torn tail from a crash mid-append: truncate to the clean
            # prefix so the next append starts on a frame boundary
            self.stats.truncated_bytes += len(data) - clean
            self._log.close()
            with open(self.log_path, "r+b") as f:
                f.truncate(clean)
            self._log = open(self.log_path, "ab")
        return records

    def iter_records(self) -> Iterator[Any]:
        """Convenience: replayed records only (tests / tooling)."""
        _, records = self.load()
        return iter(records)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            try:
                self._log.close()
            except OSError:  # pragma: no cover
                pass

    def __enter__(self) -> "CacheJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
