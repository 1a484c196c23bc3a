"""Compact frequency sketches for cross-shard demand tracking (PR 7).

The cross-shard allocation round needs each shard's *demand heat* — which
blocks keep re-missing after eviction, and how big each stream's unmet
working set is — but shipping exact per-block counters grows with the
block population (millions of distinct blocks at production scale).  This
module provides the two classic bounded-error summaries:

* :class:`CountMinSketch` — conservative-update CMS with seeded hash rows,
  NumPy-vectorized batch folding.  Point queries never under-count, and
  over-count by at most ``2/width`` of the total mass per row with
  probability ``1 - 2^-depth`` (the standard CM bound; conservative update
  only tightens it).  ``merge`` is element-wise addition, which preserves
  the over-estimate guarantee for the combined stream.
* :class:`SpaceSaving` — top-k heavy hitters with per-entry error bounds.
  Any key whose true count exceeds ``total/k`` is guaranteed present, and
  every reported count over-estimates truth by at most the recorded
  ``err``.

Both serialize to bounded O(KB) payloads (zlib over the mostly-zero CMS
table; length-prefixed entries for the top-k) so a shard's whole demand
summary fits in a few wire KB regardless of block population —
``ShardDemandTracker`` ships them over the rebalance RPC and
``GlobalRebalancer`` merges them into a cluster heat view.

:class:`DemandSketch` is the per-shard composite the cache feeds on ghost
hits (re-misses of recently evicted blocks — exactly the misses that one
more byte of quota could have saved).  The hot path is a plain list
append; hashing and sketch updates amortize over vectorized folds.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .types import CacheConfig

_CMS_MAGIC = b"CMS1"
_SS_MAGIC = b"SSK1"

# 64-bit mixing constants for the row hash family (splitmix64 increments).
_MIX = np.uint64(0x9E3779B97F4A7C15)


def stable_hash64(key: str) -> int:
    """Process-stable 64-bit hash of a string key.

    Built from two CRC-32 passes (forward and salted) — cheap, stable
    across processes (unlike the salted builtin ``hash``), and good
    enough spread once mixed through the per-row affine family.
    """
    b = key.encode("utf-8")
    lo = zlib.crc32(b)
    hi = zlib.crc32(b, 0x9E3779B9)
    return (hi << 32) | lo


def _hash_batch(keys) -> np.ndarray:
    """Vectorized :func:`stable_hash64` over a sequence of keys.

    Bound locals + a tight generator: this runs on every fold, so the
    Python-level per-key overhead matters (see the sketch micro-bench in
    ``benchmarks/allocation_micro.py``).
    """
    crc = zlib.crc32

    def gen():
        for k in keys:
            b = k.encode("utf-8")
            yield (crc(b, 0x9E3779B9) << 32) | crc(b)
    n = len(keys) if hasattr(keys, "__len__") else -1
    return np.fromiter(gen(), dtype=np.uint64, count=n)


def _mix64(h: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wrap-around intended)."""
    with np.errstate(over="ignore"):
        z = h * _MIX
        z ^= z >> np.uint64(30)
        z *= np.uint64(0xBF58476D1CE4E5B9)
        z ^= z >> np.uint64(27)
        z *= np.uint64(0x94D049BB133111EB)
        z ^= z >> np.uint64(31)
    return z


class CountMinSketch:
    """Conservative-update Count-Min sketch over string keys.

    ``depth`` seeded hash rows of ``width`` uint64 counters.  Updates are
    *conservative*: only the cells that currently hold the key's minimum
    estimate are raised, which keeps the classic over-estimate guarantee
    while shrinking collision inflation.  Batched updates
    (:meth:`update_hashed`) read all row minima first and raise cells
    with ``np.maximum.at`` — order-independent, still never
    under-counting.
    """

    def __init__(self, width: int = 512, depth: int = 3,
                 seed: int = 0) -> None:
        if width < 8 or depth < 1:
            raise ValueError(f"bad CMS geometry {width}x{depth}")
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        self.table = np.zeros((depth, width), dtype=np.uint64)
        self.total = 0          # mass added (sum of counts)
        rng = np.random.default_rng(seed)
        # odd multipliers + offsets: one affine 64-bit mix per row
        self._a = (rng.integers(1, 2**63, size=depth, dtype=np.uint64)
                   | np.uint64(1))
        self._b = rng.integers(0, 2**63, size=depth, dtype=np.uint64)
        self._rows = np.arange(depth)

    # ------------------------------------------------------------- hashing
    def _indices(self, hashes: np.ndarray) -> np.ndarray:
        """(depth, n) column indices for n pre-hashed keys."""
        with np.errstate(over="ignore"):
            mixed = _mix64(hashes[None, :] * self._a[:, None]
                           + self._b[:, None])
        return (mixed % np.uint64(self.width)).astype(np.int64)

    # ------------------------------------------------------------- updates
    def update(self, key: str, count: int = 1) -> None:
        self.update_hashed(np.array([stable_hash64(key)], dtype=np.uint64),
                           np.array([count], dtype=np.uint64))

    def update_batch(self, keys: Iterable[str], count: int = 1) -> None:
        """Fold a batch of key occurrences (each counted ``count`` times)."""
        h = _hash_batch(list(keys))
        if h.size == 0:
            return
        uniq, cnt = np.unique(h, return_counts=True)
        self.update_hashed(uniq, cnt.astype(np.uint64) * np.uint64(count))

    def update_counted(self, counted: Dict[str, int]) -> None:
        """Fold pre-aggregated ``{key: count}`` occurrences (hashes only
        the distinct keys — the fast path when the caller already holds a
        Counter).  64-bit hash collisions between distinct keys are
        summed (they share cells anyway), keeping the no-under-count
        invariant."""
        if not counted:
            return
        h = _hash_batch(list(counted))
        c = np.fromiter(counted.values(), dtype=np.uint64, count=len(counted))
        uniq, inv = np.unique(h, return_inverse=True)
        # align counts with the (sorted) unique hashes; colliding distinct
        # keys sum their counts
        aligned = np.zeros(uniq.size, dtype=np.uint64)
        np.add.at(aligned, inv, c)
        self.update_hashed(uniq, aligned)

    def update_hashed(self, hashes: np.ndarray, counts: np.ndarray) -> None:
        """Conservative batch update for pre-hashed *distinct* keys."""
        if hashes.size == 0:
            return
        idx = self._indices(hashes)
        cur = self.table[self._rows[:, None], idx]        # (depth, n)
        target = cur.min(axis=0) + counts                 # new min estimate
        np.maximum.at(self.table, (self._rows[:, None], idx),
                      np.broadcast_to(target, cur.shape))
        self.total += int(counts.sum())

    # ------------------------------------------------------------- queries
    def query(self, key: str) -> int:
        return int(self.query_hashed(
            np.array([stable_hash64(key)], dtype=np.uint64))[0])

    def query_hashed(self, hashes: np.ndarray) -> np.ndarray:
        if hashes.size == 0:
            return np.zeros(0, dtype=np.uint64)
        idx = self._indices(hashes)
        return self.table[self._rows[:, None], idx].min(axis=0)

    # ------------------------------------------------------------- algebra
    def compatible(self, other: "CountMinSketch") -> bool:
        return (self.width == other.width and self.depth == other.depth
                and self.seed == other.seed)

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        """Element-wise sum: estimates of the union stream still never
        under-count (min of sums >= sum of mins >= truth)."""
        if not self.compatible(other):
            raise ValueError("merging incompatible CMS geometries/seeds")
        self.table += other.table
        self.total += other.total
        return self

    def reset(self) -> None:
        self.table[:] = 0
        self.total = 0

    # --------------------------------------------------------------- wire
    def serialize(self) -> bytes:
        body = zlib.compress(self.table.tobytes(), 6)
        head = struct.pack(">4sIIIQ", _CMS_MAGIC, self.width, self.depth,
                           self.seed, self.total)
        return head + body

    @classmethod
    def deserialize(cls, data: bytes) -> "CountMinSketch":
        magic, width, depth, seed, total = struct.unpack_from(">4sIIIQ",
                                                              data)
        if magic != _CMS_MAGIC:
            raise ValueError("not a CMS payload")
        out = cls(width, depth, seed)
        table = np.frombuffer(zlib.decompress(data[struct.calcsize(
            ">4sIIIQ"):]), dtype=np.uint64).reshape(depth, width)
        out.table = table.copy()
        out.total = int(total)
        return out


class SpaceSaving:
    """Stream-Summary top-k heavy hitters (Metwally et al.).

    ``counts[key]`` over-estimates the key's true count by at most
    ``errs[key]``; any key with true count > ``total/k`` is guaranteed
    to be present.  ``merge`` follows the mergeable-summaries recipe:
    sum counts/errors for shared keys, charge the other side's minimum
    count as error for one-sided keys, then re-truncate to k.
    """

    def __init__(self, k: int = 64) -> None:
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        self.counts: Dict[str, int] = {}
        self.errs: Dict[str, int] = {}
        self.total = 0

    def _min_entry(self) -> Tuple[str, int]:
        key = min(self.counts, key=self.counts.__getitem__)
        return key, self.counts[key]

    def update(self, key: str, count: int = 1) -> None:
        self.total += count
        if key in self.counts:
            self.counts[key] += count
        elif len(self.counts) < self.k:
            self.counts[key] = count
            self.errs[key] = 0
        else:
            vk, vmin = self._min_entry()
            del self.counts[vk]
            del self.errs[vk]
            self.counts[key] = vmin + count
            self.errs[key] = vmin

    def update_batch(self, keys: Iterable[str]) -> None:
        from collections import Counter
        self.update_counted(Counter(keys))

    def update_counted(self, counted: Dict[str, int]) -> None:
        """Fold pre-aggregated ``{key: count}`` occurrences in one
        merge-style pass (mergeable-summaries: the batch is an *exact*
        summary, so only the table side charges its minimum to keys it
        may have evicted).  Equivalent guarantees to per-key updates —
        counts never under-estimate, ``err`` bounds the over-estimate —
        at a fraction of the cost: one sort instead of an O(k) min-scan
        per eviction."""
        if not counted:
            return
        self.total += sum(counted.values())
        amin = (min(self.counts.values())
                if len(self.counts) >= self.k else 0)
        merged: Dict[str, Tuple[int, int]] = {}
        pending = dict(counted)
        for key, c in self.counts.items():
            merged[key] = (c + pending.pop(key, 0), self.errs[key])
        for key, c in pending.items():
            merged[key] = (c + amin, amin)
        top = sorted(merged.items(), key=lambda e: -e[1][0])[:self.k]
        self.counts = {k: c for k, (c, _) in top}
        self.errs = {k: e for k, (_, e) in top}

    def query(self, key: str) -> int:
        return self.counts.get(key, 0)

    def guaranteed(self, key: str) -> int:
        """Lower bound on the key's true count (count - err)."""
        return self.counts.get(key, 0) - self.errs.get(key, 0)

    def items(self) -> List[Tuple[str, int, int]]:
        """(key, count, err) sorted by estimated count, descending."""
        return sorted(((k, c, self.errs[k]) for k, c in self.counts.items()),
                      key=lambda e: -e[1])

    def min_count(self) -> int:
        if not self.counts:
            return 0
        return min(self.counts.values())

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        if self.k != other.k:
            raise ValueError("merging SpaceSaving summaries of different k")
        amin = self.min_count() if len(self.counts) >= self.k else 0
        bmin = other.min_count() if len(other.counts) >= other.k else 0
        merged: Dict[str, Tuple[int, int]] = {}
        for key, c in self.counts.items():
            e = self.errs[key]
            if key in other.counts:
                merged[key] = (c + other.counts[key], e + other.errs[key])
            else:
                merged[key] = (c + bmin, e + bmin)
        for key, c in other.counts.items():
            if key not in merged:
                merged[key] = (c + amin, other.errs[key] + amin)
        top = sorted(merged.items(), key=lambda e: -e[1][0])[:self.k]
        self.counts = {k: c for k, (c, _) in top}
        self.errs = {k: e for k, (_, e) in top}
        self.total += other.total
        return self

    def reset(self) -> None:
        self.counts.clear()
        self.errs.clear()
        self.total = 0

    # --------------------------------------------------------------- wire
    def serialize(self) -> bytes:
        parts = [struct.pack(">4sIIQ", _SS_MAGIC, self.k, len(self.counts),
                             self.total)]
        for key, c in self.counts.items():
            kb = key.encode("utf-8")
            parts.append(struct.pack(">HQQ", len(kb), c, self.errs[key]))
            parts.append(kb)
        return zlib.compress(b"".join(parts), 6)

    @classmethod
    def deserialize(cls, data: bytes) -> "SpaceSaving":
        raw = zlib.decompress(data)
        magic, k, n, total = struct.unpack_from(">4sIIQ", raw)
        if magic != _SS_MAGIC:
            raise ValueError("not a SpaceSaving payload")
        out = cls(k)
        off = struct.calcsize(">4sIIQ")
        for _ in range(n):
            klen, c, e = struct.unpack_from(">HQQ", raw, off)
            off += struct.calcsize(">HQQ")
            key = raw[off:off + klen].decode("utf-8")
            off += klen
            out.counts[key] = c
            out.errs[key] = e
        out.total = int(total)
        return out


class DemandSketch:
    """Per-shard ghost-hit heat: CMS + SpaceSaving fed from the cache.

    The cache calls :meth:`note` on every *ghost hit* (a miss whose block
    sits in the BufferWindow — i.e. it was evicted recently enough that
    more quota would have kept it).  Notes land in a plain list (the only
    per-access cost) and fold into both sketches in vectorized batches.

    One measurement interval spans one cross-shard round:
    ``ShardDemandTracker`` folds, reads per-stream demand via
    :meth:`distinct_under`, then :meth:`reset`\\ s the interval.
    """

    FOLD_BATCH = 4096

    def __init__(self, cfg: Optional[CacheConfig] = None,
                 width: Optional[int] = None, depth: Optional[int] = None,
                 k: Optional[int] = None, seed: int = 0) -> None:
        cfg = cfg or CacheConfig()
        self.cms = CountMinSketch(width or cfg.sketch_width,
                                  depth or cfg.sketch_depth, seed)
        self.topk = SpaceSaving(k or cfg.topk)
        self._pending: List[str] = []
        self.noted = 0          # ghost hits this interval

    # ------------------------------------------------------------ hot path
    def note(self, key: str) -> None:
        self._pending.append(key)
        if len(self._pending) >= self.FOLD_BATCH:
            self.fold()

    def fold(self) -> None:
        from collections import Counter
        batch = self._pending
        if not batch:
            return
        self._pending = []
        self.noted += len(batch)
        # aggregate once, hash only the distinct keys, and feed both
        # sketches the counted form — the fold cost is dominated by
        # per-distinct-key work, not batch length
        cnt = Counter(batch)
        self.cms.update_counted(cnt)
        self.topk.update_counted(cnt)

    # ------------------------------------------------------------- queries
    def distinct_under(self, prefix: str) -> Tuple[int, int]:
        """(distinct_head, head_mass) for keys under ``prefix``.

        ``distinct_head`` counts the tracked heavy hitters under the
        prefix; ``head_mass`` is the ghost-hit mass they account for
        (guaranteed lower bounds, so the caller's exact per-stream hit
        counter minus ``head_mass`` upper-bounds the *tail* — blocks too
        cold for the top-k, each contributing at least one hit).
        Callers turn head + tail into a working-set byte estimate.
        """
        self.fold()
        head = 0
        head_mass = 0
        for key, count, err in self.topk.items():
            if key.startswith(prefix):
                head += 1
                head_mass += max(1, count - err)
        return head, head_mass

    def reset(self) -> None:
        self._pending.clear()
        self.cms.reset()
        self.topk.reset()
        self.noted = 0

    # --------------------------------------------------------------- wire
    def serialize(self) -> Tuple[bytes, bytes]:
        self.fold()
        return self.cms.serialize(), self.topk.serialize()
