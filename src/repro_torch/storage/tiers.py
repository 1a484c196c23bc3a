"""Tiered cache storage: a RAM block tier over a spill-to-disk tier.

The kernel cache is *accounting-only*: it decides which blocks deserve
residency, but the repo carried no payload store — a "hit" still fetched
its bytes from the backing store.  :class:`TieredStore` closes that gap
as a new layer between the client and any backing store: a **RAM tier**
holding whole-block payloads, spilling its evictions to a **local-disk
tier** (real checksummed files under a spill directory with their own
capacity, LRU order and promote-on-hit), composed behind the ordinary
``BackingStore`` v2 surface — ``open_cache`` stacks (thread driver,
process driver, the cache daemon) get tiering with zero API changes:

    store = open_store("tiered+file:///data?ram_mb=64&disk_mb=256")
    client = open_cache(store, capacity, fetch_bytes=True)

Placement is **pattern-aware**, reusing the classifier verdicts the
engine already produces.  The engine duck-types two optional hooks on
its ``meta`` object (see ``core.igtcache``):

* ``note_pattern(top, pattern, pin_ram)`` — the per-dataset placement
  hint (``core.allocation.placement_hint``), pushed on change;
* ``note_evicted(key, size)`` — every kernel eviction, the spill signal.

Policy (HugeCTR's HMEM-Cache host-memory block tier is the exemplar —
the HMEM-Cache design):

* **SEQUENTIAL** extents are disk-eligible but not worth RAM residency:
  block fills write *through* to the disk tier (a re-scan streams from
  local disk instead of the remote), never displacing RAM blocks;
* **SKEWED** hot blocks pin in RAM: their entries are sticky — the RAM
  LRU prefers non-sticky victims;
* **RANDOM / UNKNOWN** follow target-hit-rate-gated admission: when the
  tier's recent hit rate already meets ``target_hit_rate`` and RAM is
  full, new insertions are skipped ("if the actual hit rate is greater
  than this value, no eviction/insertion will happen").

Two modes share one policy engine:

* ``mode="bytes"`` (default) — real payloads: RAM dict + spill files
  (``IGTS`` header, CRC-32 payload checksum, atomic tmp+rename writes,
  warm-restart re-index).  A truncated or checksum-failing spill file
  degrades to a clean miss (the file is dropped, bytes re-fetched from
  the inner store — corrupt bytes never reach a caller); a full spill
  dir falls back to RAM-only with a counted stat.
* ``mode="index"`` — residency accounting only (no payloads, no files):
  a discrete-event cluster simulator moves no bytes, so it
  consults ``sim_read(key, size)`` per missed block to decide local-disk
  vs remote-link cost (the tier-aware bytes-moved model).
"""
from __future__ import annotations

import os
import struct
import tempfile
import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.types import MB, PathT, split_block_key
from .api import (BackingStore, RangeRequest, StoreCapabilities,
                  as_backing_store)

__all__ = ["DiskTier", "TIER_KEYS", "TieredStore", "TierStats"]

# query/override keys open_store routes to the TieredStore constructor
# (everything else configures the inner scheme)
TIER_KEYS = ("ram_bytes", "disk_bytes", "ram_mb", "disk_mb", "spill_dir",
             "mode", "target_hit_rate", "hit_window")

SEQUENTIAL, RANDOM, SKEWED, UNKNOWN = ("sequential", "random", "skewed",
                                       "unknown")


class TierStats:
    """Counter block for one :class:`TieredStore` (all under its lock)."""

    __slots__ = ("ram_hits", "disk_hits", "misses", "pass_through",
                 "ram_hit_bytes", "disk_hit_bytes", "remote_bytes",
                 "spills", "spill_bytes", "spill_errors", "promotes",
                 "ram_evictions", "disk_evictions", "checksum_failures",
                 "admission_skips", "restored", "prefetch_disk_hits",
                 "prefetch_disk_bytes")

    def __init__(self) -> None:
        for name in self.__slots__:
            setattr(self, name, 0)

    def snapshot(self) -> dict:
        return {name: getattr(self, name) for name in self.__slots__}


# spill-file header: magic, format version, key length; CRC-32 and byte
# length of the payload (the key itself follows, then the payload)
_MAGIC = b"IGTS"
_HEADER = struct.Struct("<4sBHIQ")
_VERSION = 1


class DiskTier:
    """The spill tier: capacity-bounded LRU of whole-block entries.

    ``payload=True`` keeps real files under ``root`` (one per block,
    checksummed, written atomically via tmp+rename so a crash never
    leaves a half-visible entry); ``payload=False`` is the index-only
    mode for simulators that track residency without moving bytes.  Not
    thread-safe on its own — the owning :class:`TieredStore` serializes
    access under one lock.
    """

    def __init__(self, capacity: int, root: Optional[str] = None,
                 payload: bool = True,
                 stats: Optional[TierStats] = None) -> None:
        self.capacity = capacity
        self.root = root
        self.payload = payload
        self.stats = stats if stats is not None else TierStats()
        self.used = 0
        # key -> (size, filename-or-None), LRU order (oldest first)
        self.index: "OrderedDict[str, Tuple[int, Optional[str]]]" = \
            OrderedDict()
        self._spill_fails = 0        # consecutive write failures
        self.disabled = False        # spill-dir-full / sick-disk fallback
        if capacity <= 0:
            # RAM-only configuration: the disk tier exists but never admits
            self.disabled = True
        elif payload:
            if root is None:
                raise ValueError("payload disk tier needs a spill dir")
            os.makedirs(root, exist_ok=True)
            self._reindex()

    # -- warm restart --------------------------------------------------------
    def _reindex(self) -> None:
        """Re-adopt spill files left by a previous process (daemon or
        worker restart with a warm spill directory).  Unparseable files
        are deleted; LRU order follows mtime."""
        entries: List[Tuple[float, str, str, int]] = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(".blk"):
                continue
            fpath = os.path.join(self.root, name)
            try:
                with open(fpath, "rb") as f:
                    head = f.read(_HEADER.size)
                    magic, ver, klen, _crc, size = _HEADER.unpack(head)
                    if magic != _MAGIC or ver != _VERSION:
                        raise ValueError("bad spill header")
                    key = f.read(klen).decode("utf-8")
                mtime = os.path.getmtime(fpath)
            except (OSError, ValueError, struct.error, UnicodeDecodeError):
                self._unlink(fpath)
                continue
            entries.append((mtime, key, name, size))
        for _mtime, key, name, size in sorted(entries):
            self.index[key] = (size, name)
            self.used += size
            self.stats.restored += 1
        while self.used > self.capacity:
            if not self.evict_lru():
                break

    # -- entry plumbing ------------------------------------------------------
    @staticmethod
    def _fname(key: str) -> str:
        import hashlib
        return hashlib.blake2b(key.encode(), digest_size=12).hexdigest() \
            + ".blk"

    def _unlink(self, fpath: str) -> None:
        try:
            os.unlink(fpath)
        except OSError:
            pass

    def __contains__(self, key: str) -> bool:
        return key in self.index

    def touch(self, key: str) -> None:
        if key in self.index:
            self.index.move_to_end(key)

    def put(self, key: str, size: int,
            data: Optional[np.ndarray] = None) -> bool:
        """Admit one block (re-admitting an existing key is a cheap LRU
        refresh — the spill file is already on disk).  Returns False when
        the entry could not be admitted (disk disabled / write failed)."""
        if key in self.index:
            self.index.move_to_end(key)
            return True
        if self.disabled or size > self.capacity:
            return False
        while self.used + size > self.capacity:
            if not self.evict_lru():
                return False
        name: Optional[str] = None
        if self.payload:
            if data is None:
                return False         # nothing to write (no payload in hand)
            name = self._fname(key)
            if not self._write(key, data, name):
                return False
        self.index[key] = (size, name)
        self.used += size
        self.stats.spills += 1
        self.stats.spill_bytes += size
        return True

    def _write(self, key: str, data: np.ndarray, name: str) -> bool:
        kb = key.encode("utf-8")
        payload = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
        head = _HEADER.pack(_MAGIC, _VERSION, len(kb),
                            zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
        fpath = os.path.join(self.root, name)
        tmp = os.path.join(self.root, f".{name}.{os.getpid()}.tmp")
        try:
            with open(tmp, "wb") as f:
                f.write(head)
                f.write(kb)
                f.write(payload)
            os.replace(tmp, fpath)
        except OSError:
            # spill dir full / sick disk: count it, drop the entry, and
            # after a few consecutive failures stop trying (RAM-only
            # fallback) instead of hammering a dead device
            self._unlink(tmp)
            self.stats.spill_errors += 1
            self._spill_fails += 1
            if self._spill_fails >= 8:
                self.disabled = True
            return False
        self._spill_fails = 0
        return True

    def get(self, key: str) -> Optional[np.ndarray]:
        """Payload for ``key`` (refreshes LRU), or None.  A truncated or
        checksum-failing file is dropped and reported as a miss — corrupt
        bytes never reach the caller."""
        entry = self.index.get(key)
        if entry is None:
            return None
        size, name = entry
        if not self.payload or name is None:
            self.index.move_to_end(key)
            return None
        fpath = os.path.join(self.root, name)
        try:
            with open(fpath, "rb") as f:
                head = f.read(_HEADER.size)
                magic, ver, klen, crc, length = _HEADER.unpack(head)
                if magic != _MAGIC or ver != _VERSION:
                    raise ValueError("bad spill header")
                fkey = f.read(klen).decode("utf-8")
                payload = f.read(length)
            if fkey != key or len(payload) != length or \
                    zlib.crc32(payload) & 0xFFFFFFFF != crc:
                raise ValueError("spill payload corrupt")
        except (OSError, ValueError, struct.error, UnicodeDecodeError):
            self.stats.checksum_failures += 1
            self.remove(key)
            return None
        self.index.move_to_end(key)
        arr = np.frombuffer(payload, dtype=np.uint8)
        arr.flags.writeable = False
        return arr

    def remove(self, key: str) -> None:
        entry = self.index.pop(key, None)
        if entry is None:
            return
        size, name = entry
        self.used -= size
        if self.payload and name is not None:
            self._unlink(os.path.join(self.root, name))

    def evict_lru(self) -> bool:
        if not self.index:
            return False
        key, (size, name) = self.index.popitem(last=False)
        self.used -= size
        self.stats.disk_evictions += 1
        if self.payload and name is not None:
            self._unlink(os.path.join(self.root, name))
        return True


class _RamEntry:
    __slots__ = ("data", "size", "sticky")

    def __init__(self, data: Optional[np.ndarray], size: int,
                 sticky: bool) -> None:
        self.data = data
        self.size = size
        self.sticky = sticky


class TieredStore(BackingStore):
    """RAM + spill-to-disk payload tiers over any byte-serving store.

    Transparent to the kernel: metadata calls pass through to ``inner``
    (which keeps backing the engine's ``StoreMeta``), and every fetch
    returns exactly the bytes the inner store would have served — the
    tiers only change *where* they come from.  Only whole-block fills
    (offset 0, length = the block's populated size) are admitted; partial
    ranges are served by slicing a resident block, or pass through
    uncached (a 4 KB range must never masquerade as a 4 MB block).
    """

    def __init__(self, inner, *, ram_bytes: int = 64 * MB,
                 disk_bytes: int = 256 * MB,
                 ram_mb: Optional[int] = None,
                 disk_mb: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 mode: str = "bytes",
                 target_hit_rate: float = 0.8,
                 hit_window: int = 256) -> None:
        backing = as_backing_store(inner)
        if backing is None:
            raise TypeError(
                f"TieredStore needs a byte-serving store, got {inner!r}")
        if mode not in ("bytes", "index"):
            raise ValueError(f"unknown tier mode {mode!r}; expected "
                             f"'bytes' or 'index'")
        if ram_mb is not None:
            ram_bytes = int(ram_mb) * MB
        if disk_mb is not None:
            disk_bytes = int(disk_mb) * MB
        self.inner = inner            # metadata passthrough target
        self._backing = backing       # normalized fetch target
        self.mode = mode
        self.ram_bytes = int(ram_bytes)
        self.disk_bytes = int(disk_bytes)
        self.target_hit_rate = float(target_hit_rate)
        self.hit_window = max(16, int(hit_window))
        if mode == "bytes" and spill_dir is None and disk_bytes > 0:
            spill_dir = tempfile.mkdtemp(prefix="igt-spill-")
        self.spill_dir = spill_dir
        self.stats = TierStats()
        self._ram: "OrderedDict[str, _RamEntry]" = OrderedDict()
        self._ram_used = 0
        self.disk = DiskTier(self.disk_bytes, spill_dir,
                             payload=(mode == "bytes"), stats=self.stats)
        # placement hints: dataset top component -> (pattern, pin_ram)
        self._patterns: Dict[str, Tuple[str, bool]] = {}
        # recent-window hit-rate for the HMEM-style admission gate
        self._win_lookups = 0
        self._win_hits = 0
        self._recent_rate: Optional[float] = None
        self._lock = threading.Lock()

    # -- wrapper plumbing ----------------------------------------------------
    def capabilities(self) -> StoreCapabilities:
        return self._backing.capabilities()

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    @property
    def reopen_by_uri(self) -> bool:
        # a tiered stack is reconstructable from its URI exactly when the
        # inner store is (tiered+file:// yes; tiered+sim:// with datasets
        # registered post-open must travel as the object)
        return bool(getattr(self.inner, "reopen_by_uri", False))

    # -- placement hooks (driven by core.igtcache) ---------------------------
    def note_pattern(self, top: str, pattern: str,
                     pin_ram: bool = False) -> None:
        """Engine placement hint for the dataset rooted at ``top``."""
        with self._lock:
            self._patterns[str(top)] = (str(pattern), bool(pin_ram))

    def note_evicted(self, key: str, size: int) -> None:
        """Kernel eviction: the block leaves RAM-worthiness — spill it.

        In bytes mode the payload (when the RAM tier holds it) moves to
        the disk tier; in index mode the key is admitted to the disk
        residency index (the simulator's spill signal)."""
        with self._lock:
            pattern, _pin = self._pattern_for(key)
            if self.mode == "index":
                if self._admission_gated(pattern):
                    self.stats.admission_skips += 1
                    return
                self.disk.put(key, size)
                return
            entry = self._ram.pop(key, None)
            if entry is None:
                return               # no payload in hand: nothing to spill
            self._ram_used -= entry.size
            self.disk.put(key, entry.size, entry.data)

    # -- fetch path ----------------------------------------------------------
    def _block_info(self, path: PathT, offset: int,
                    length: int) -> Tuple[Optional[str], int]:
        """(residency key, populated block length) when ``path`` is a
        block path and the range fits inside it; (None, 0) otherwise."""
        file_path, b = split_block_key(path)
        if b is None:
            return None, 0
        try:
            bs = int(self.inner.block_size)
            fsize = int(self.inner.file_size(file_path))
        except (AttributeError, TypeError):
            return None, 0
        blk_len = min(bs, fsize - b * bs)
        if blk_len <= 0 or offset < 0 or offset + length > blk_len:
            return None, 0
        return "/".join(path), blk_len

    def _pattern_for(self, key: str) -> Tuple[str, bool]:
        top = key.split("/", 1)[0]
        return self._patterns.get(top, (UNKNOWN, False))

    def _note_lookup(self, hit: bool) -> None:
        self._win_lookups += 1
        if hit:
            self._win_hits += 1
        if self._win_lookups >= self.hit_window:
            self._recent_rate = self._win_hits / self._win_lookups
            self._win_lookups = 0
            self._win_hits = 0

    def _admission_gated(self, pattern: str) -> bool:
        """HMEM-Cache idiom: when the tier already meets its target hit
        rate, RANDOM/UNKNOWN insertions (and their eviction churn) are
        skipped.  SEQUENTIAL and SKEWED placement is structural and never
        gated."""
        if pattern in (SEQUENTIAL, SKEWED):
            return False
        return (self._recent_rate is not None
                and self._recent_rate >= self.target_hit_rate)

    def _ram_put(self, key: str, data: np.ndarray, size: int,
                 sticky: bool) -> None:
        if size > self.ram_bytes:
            return
        old = self._ram.pop(key, None)
        if old is not None:
            self._ram_used -= old.size
        while self._ram_used + size > self.ram_bytes:
            if not self._ram_evict_one():
                return
        self._ram[key] = _RamEntry(data, size, sticky)
        self._ram_used += size

    def _ram_evict_one(self) -> bool:
        """LRU with SKEWED pinning: prefer the oldest non-sticky entry;
        only when everything is sticky does a sticky block leave."""
        victim = None
        for k, e in self._ram.items():
            if not e.sticky:
                victim = k
                break
        if victim is None:
            if not self._ram:
                return False
            victim = next(iter(self._ram))
        entry = self._ram.pop(victim)
        self._ram_used -= entry.size
        self.stats.ram_evictions += 1
        self.disk.put(victim, entry.size, entry.data)
        return True

    def _admit_fill(self, key: str, data: np.ndarray, size: int) -> None:
        """Place one freshly fetched whole block per the pattern hint."""
        pattern, pin = self._pattern_for(key)
        if pattern == SEQUENTIAL:
            # streamed data: disk-eligible, never worth RAM residency
            self.disk.put(key, size, data)
            return
        if self._ram_used + size > self.ram_bytes \
                and self._admission_gated(pattern):
            self.stats.admission_skips += 1
            return
        self._ram_put(key, data, size, sticky=(pattern == SKEWED or pin))

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        key, blk_len = self._block_info(path, offset, length)
        if key is None:
            with self._lock:
                self.stats.pass_through += 1
            return self._backing.fetch_range(path, offset, length)
        with self._lock:
            got = self._serve_resident(key, offset, length)
        if got is not None:
            return got
        full = (offset == 0 and length == blk_len)
        if not full:
            # partial miss: move only the requested bytes, uncached
            with self._lock:
                self.stats.pass_through += 1
            return self._backing.fetch_range(path, offset, length)
        data = self._backing.fetch_range(path, 0, blk_len)
        self._fill(key, data, blk_len)
        return data

    def _serve_resident(self, key: str, offset: int,
                        length: int) -> Optional[np.ndarray]:
        """Tier lookup under the lock: RAM slice, else disk payload with
        promote-on-hit (the disk entry is retained, so re-spilling the
        block later is a free LRU refresh)."""
        entry = self._ram.get(key)
        if entry is not None and entry.data is not None:
            self._ram.move_to_end(key)
            self._note_lookup(hit=True)
            self.stats.ram_hits += 1
            self.stats.ram_hit_bytes += length
            return entry.data[offset:offset + length]
        data = self.disk.get(key)
        if data is not None:
            self._note_lookup(hit=True)
            self.stats.disk_hits += 1
            self.stats.disk_hit_bytes += length
            pattern, pin = self._pattern_for(key)
            if pattern != SEQUENTIAL:   # sequential streams from disk
                self.stats.promotes += 1
                self._ram_put(key, data, len(data),
                              sticky=(pattern == SKEWED or pin))
            return data[offset:offset + length]
        self._note_lookup(hit=False)
        self.stats.misses += 1
        self.stats.remote_bytes += length
        return None

    def _fill(self, key: str, data: np.ndarray, size: int) -> None:
        arr = np.array(data, dtype=np.uint8, copy=True)
        arr.flags.writeable = False
        with self._lock:
            self._admit_fill(key, arr, size)

    def fetch_many(self, requests: Sequence[RangeRequest]
                   ) -> List[np.ndarray]:
        """Tier-resident ranges served locally; the remainder goes to the
        inner store as **one** batched ``fetch_many`` (preserving the
        per-shard demand-batching win), then whole-block fills are
        admitted per the placement policy."""
        out: List[Optional[np.ndarray]] = [None] * len(requests)
        miss_idx: List[int] = []
        miss_reqs: List[RangeRequest] = []
        fills: List[Tuple[int, str, int]] = []  # (out idx, key, blk_len)
        with self._lock:
            for i, (path, offset, length) in enumerate(requests):
                key, blk_len = self._block_info(path, offset, length)
                if key is None:
                    self.stats.pass_through += 1
                    miss_idx.append(i)
                    miss_reqs.append((path, offset, length))
                    continue
                got = self._serve_resident(key, offset, length)
                if got is not None:
                    out[i] = got
                elif offset == 0 and length == blk_len:
                    miss_idx.append(i)
                    miss_reqs.append((path, 0, blk_len))
                    fills.append((i, key, blk_len))
                else:
                    self.stats.pass_through += 1
                    miss_idx.append(i)
                    miss_reqs.append((path, offset, length))
        if miss_reqs:
            fetched = self._backing.fetch_many(miss_reqs)
            for i, data in zip(miss_idx, fetched):
                out[i] = data
            for i, key, blk_len in fills:
                self._fill(key, out[i], blk_len)
        return out  # type: ignore[return-value]

    def fetch_block(self, path: PathT, size: int) -> np.ndarray:
        return self.fetch_range(path, 0, size)

    # -- simulator surface (mode="index", but works for both) ---------------
    def sim_read(self, key: str, size: int, prefetch: bool = False) -> bool:
        """Residency probe for the discrete-event simulator: True when
        the missed block is disk-tier resident (serve at local-disk cost
        instead of a remote-link transfer).  Non-sequential hits promote
        (the entry leaves the disk index — the kernel re-admits the block
        to its RAM accounting); sequential data streams from disk and
        stays.  A miss admits the key per the placement policy, modelling
        the write-through/spill the bytes-mode fill path performs."""
        with self._lock:
            pattern, _pin = self._pattern_for(key)
            if key in self.disk:
                if prefetch:
                    self.stats.prefetch_disk_hits += 1
                    self.stats.prefetch_disk_bytes += size
                else:
                    self._note_lookup(hit=True)
                    self.stats.disk_hits += 1
                    self.stats.disk_hit_bytes += size
                if pattern == SEQUENTIAL:
                    self.disk.touch(key)
                else:
                    self.stats.promotes += 1
                    self.disk.remove(key)
                return True
            if not prefetch:
                self._note_lookup(hit=False)
                self.stats.misses += 1
                self.stats.remote_bytes += size
                if self._admission_gated(pattern):
                    self.stats.admission_skips += 1
                else:
                    self.disk.put(key, size)
            return False

    # -- observability -------------------------------------------------------
    def tier_stats(self) -> dict:
        with self._lock:
            snap = self.stats.snapshot()
            snap.update({
                "mode": self.mode,
                "ram_bytes": self.ram_bytes,
                "disk_bytes": self.disk_bytes,
                "ram_used": self._ram_used,
                "disk_used": self.disk.used,
                "ram_blocks": len(self._ram),
                "disk_blocks": len(self.disk.index),
                "disk_disabled": self.disk.disabled,
                "spill_dir": self.spill_dir,
                "target_hit_rate": self.target_hit_rate,
                "patterns": dict(self._patterns),
            })
            return snap
