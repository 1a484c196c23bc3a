"""Unified cache space management: UnifiedCache + CacheManageUnit (§3.3, §4).

A *CacheManageUnit* (CMU) enforces space isolation for one top-level
AccessStream (the shallowest non-trivial node — in practice the dataset/job
root).  Within a CMU, *SubStreams* — one per governing pattern node — carry
pattern-specific eviction policies (a multi-modal dataset like LLaVa holds a
sequential text sub-stream and a random image sub-stream under one quota).

Victim priority when a CMU must make room:
  1. consumed blocks of eager (sequential) sub-streams — free by definition;
  2. the requesting sub-stream's own policy;
  3. other evictable sub-streams (skewed LRU, default LRU);
  4. uniform (random-pattern) sub-streams refuse — the block is simply not
     admitted (uniform caching never thrashes), unless the eviction is forced
     by a quota shrink.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .allocation import BufferWindow
from .eviction import (ARC, EagerEviction, EvictionPolicy, LRU, UniformCache,
                       make_policy)
from .sketch import DemandSketch
from .types import CacheConfig, CacheStats, PathT, Pattern

BlockKey = str


def path_key(path: PathT) -> BlockKey:
    """String residency key for a block path (the ``UnifiedCache`` key
    space).  Block *paths* themselves are built with
    ``types.block_key(path, idx)``."""
    return "/".join(path)


PATTERN_POLICY = {
    Pattern.SEQUENTIAL: "eager",
    Pattern.RANDOM: "uniform",
    Pattern.SKEWED: "lru",
    Pattern.UNKNOWN: "lru",
}


class SubStream:
    """Blocks governed by one pattern node inside a CMU."""

    __slots__ = ("path", "pattern", "policy", "blocks")

    def __init__(self, path: PathT, pattern: Pattern, policy: EvictionPolicy) -> None:
        self.path = path
        self.pattern = pattern
        self.policy = policy
        self.blocks: Dict[BlockKey, int] = {}

    def switch_pattern(self, pattern: Pattern, capacity_blocks: int) -> None:
        """Re-instantiate the policy on a pattern change, keeping residents."""
        if pattern is self.pattern:
            return
        self.pattern = pattern
        new_policy = make_policy(PATTERN_POLICY[pattern], capacity_blocks)
        for k in self.blocks:
            new_policy.record_insert(k)
        if isinstance(new_policy, EagerEviction):
            # Carried-over residents were demand-read in the past — under a
            # sequential pattern they are behind the stream position.
            new_policy.mark_consumed(list(self.blocks))
        self.policy = new_policy


class CacheManageUnit:
    """Per-stream quota + policy enforcement (§4 'CacheManageUnit')."""

    def __init__(self, root_path: PathT, quota: int, cfg: CacheConfig,
                 on_evict: Callable[[BlockKey, int], None],
                 dataset_bytes: int = 0) -> None:
        self.root_path = root_path
        self.quota = quota
        self.cfg = cfg
        self.used = 0
        self.substreams: Dict[PathT, SubStream] = {}
        self.block_sub: Dict[BlockKey, SubStream] = {}
        self.buffer_window = BufferWindow(cfg.buffer_window)
        self.dataset_bytes = dataset_bytes
        self._on_evict = on_evict        # notifies the UnifiedCache
        self._recent_times: deque = deque(maxlen=256)
        self.ttl: Optional[float] = None
        self.last_access_time = 0.0
        self.stat_prefetch_done = False
        self.created_at = 0.0
        self.hits = 0
        self.misses = 0
        self.bytes_accessed = 0
        self.max_gap = 0.0  # largest inter-access gap seen (stall guard)
        # Dataset-granularity pattern analysis over the *flattened* global
        # block index (catches skew spread across few big files, which
        # per-level gap analysis fragments).  Ring buffer (plain list, made
        # an ndarray only at analysis): note_flat() runs once per block on
        # the hot path.
        self._flat_idx: List[int] = [0] * cfg.window
        self._flat_pos = 0
        self._flat_count = 0
        self.flat_pattern = Pattern.UNKNOWN
        self._flat_seen = 0
        self._flat_analyzed_at = 0
        self._flat_total = 0
        # _make_room is a pure function of the CMU's residency/policy state;
        # cache a failed verdict until that state changes (a full uniform
        # stream would otherwise walk the whole eviction ladder on every
        # miss).  Bumped by _evict, successful admits, quota changes and
        # substream creation/switches.
        self._mutations = 0
        self._no_room_at = -1
        self._no_room_sub: Optional[SubStream] = None

    # -- substream plumbing ---------------------------------------------------
    def substream(self, node_path: PathT, pattern: Pattern) -> SubStream:
        sub = self.substreams.get(node_path)
        if sub is None:
            cap_blocks = max(1, self.quota // self.cfg.block_size)
            sub = SubStream(node_path, pattern,
                            make_policy(PATTERN_POLICY[pattern], cap_blocks))
            self.substreams[node_path] = sub
            self._mutations += 1
        elif sub.pattern is not pattern:
            cap_blocks = max(1, self.quota // self.cfg.block_size)
            sub.switch_pattern(pattern, cap_blocks)
            self._mutations += 1
            if pattern is Pattern.RANDOM:
                self.stat_prefetch_done = False
        return sub

    # -- accounting -------------------------------------------------------------
    def note_access(self, now: float, nbytes: int = 0) -> None:
        if self.last_access_time and now > self.last_access_time:
            self.max_gap = max(self.max_gap, now - self.last_access_time)
        self._recent_times.append(now)
        self.last_access_time = now
        self.bytes_accessed += nbytes

    def mean_access_size(self) -> int:
        n = self.hits + self.misses
        return max(1, self.bytes_accessed // n) if n else self.cfg.block_size

    def note_flat(self, ordinal: int, total: int, now: float) -> Pattern:
        """Record the flattened block ordinal and (re)classify the stream at
        dataset granularity (vectorized over the ring-buffer window)."""
        pos = self._flat_pos
        w = self.cfg.window
        self._flat_idx[pos] = ordinal
        self._flat_pos = 0 if pos + 1 == w else pos + 1
        if self._flat_count < w:
            self._flat_count += 1
        self._flat_total = total
        self._flat_seen += 1
        if (self._flat_seen >= w
                and (self.flat_pattern is Pattern.UNKNOWN
                     or self._flat_seen - self._flat_analyzed_at
                     >= self.cfg.reanalyze_every)):
            from .pattern import classify_batch
            self._flat_analyzed_at = self._flat_seen
            res = classify_batch([(self.flat_window(), total)], self.cfg)[0]
            self.flat_pattern = res.pattern
        return self.flat_pattern

    def flat_window(self) -> np.ndarray:
        """Chronological flattened-index window (fresh ndarray)."""
        from .access_stream_tree import ring_chrono
        return np.array(ring_chrono(self._flat_idx, self._flat_pos,
                                    self._flat_count, self.cfg.window),
                        dtype=np.int64)

    def effective_ttl(self) -> Optional[float]:
        """Fitted TTL, guarded against recurring I/O stalls: a stream that
        once stalled for G seconds must be idle for at least 2G + base before
        being presumed finished."""
        if self.ttl is None:
            return None
        return max(self.ttl, 2.0 * self.max_gap + self.cfg.ttl_base)

    def arrival_rate(self, now: float) -> float:
        if len(self._recent_times) < 2:
            return 0.0
        first, last = self._recent_times[0], self._recent_times[-1]
        # decay: an idle stream's rate falls as `now` moves past its last
        # access (otherwise finished jobs keep a frozen high benefit)
        span = max(1e-9, last - first, now - first)
        return (len(self._recent_times) - 1) / span

    def mean_access_gap(self, now: float = 0.0) -> Optional[float]:
        rate = self.arrival_rate(now)
        return 1.0 / rate if rate > 0 else None

    def effective_pattern(self) -> Pattern:
        """Stream pattern at dataset granularity: the flattened-index
        classification when available, else the dominant sub-stream."""
        if self.flat_pattern is not Pattern.UNKNOWN:
            return self.flat_pattern
        if not self.substreams:
            return Pattern.UNKNOWN
        best, best_w = Pattern.UNKNOWN, -1.0
        for sub in self.substreams.values():
            w = float(sum(sub.blocks.values())) + len(sub.blocks) + 1.0
            if sub.pattern is not Pattern.UNKNOWN and w > best_w:
                best, best_w = sub.pattern, w
        return best

    # -- residency ----------------------------------------------------------------
    def resident(self, key: BlockKey) -> bool:
        return key in self.block_sub

    def on_hit(self, key: BlockKey) -> None:
        sub = self.block_sub.get(key)
        if sub is not None:
            sub.policy.record_access(key, hit=True)

    def after_read(self, key: BlockKey) -> None:
        """Eager eviction: a consumed sequential block leaves immediately."""
        sub = self.block_sub.get(key)
        if sub is not None and isinstance(sub.policy, EagerEviction):
            self._evict(key, sub, ghost=False)

    def on_miss(self, key: BlockKey, sub: SubStream) -> None:
        sub.policy.record_access(key, hit=False)
        self.buffer_window.probe(key)

    def admit(self, key: BlockKey, size: int, sub: SubStream) -> bool:
        """Try to admit a fetched block under the quota; False = not cached."""
        if key in self.block_sub:
            return True
        if size > self.quota:
            return False
        if not sub.policy.admit(key):
            return False
        if self.used + size > self.quota:
            if self._no_room_at == self._mutations and self._no_room_sub is sub:
                return False    # nothing changed since the last failed search
            while self.used + size > self.quota:
                if not self._make_room(sub):
                    self._no_room_at = self._mutations
                    self._no_room_sub = sub
                    return False
        sub.blocks[key] = size
        sub.policy.record_insert(key)
        self.block_sub[key] = sub
        self.used += size
        self._mutations += 1
        return True

    def _make_room(self, requester: SubStream) -> bool:
        # 1. consumed eager blocks anywhere
        for sub in self.substreams.values():
            if isinstance(sub.policy, EagerEviction):
                k = sub.policy.consumed_victim()
                if k is not None and k in sub.blocks:
                    self._evict(k, sub, ghost=False)
                    return True
        # 2. requester's own policy
        v = requester.policy.choose_victim()
        if v is not None and v in requester.blocks:
            self._evict(v, requester)
            return True
        # 3. other evictable substreams
        for sub in self.substreams.values():
            if sub is requester or isinstance(sub.policy, UniformCache):
                continue
            v = sub.policy.choose_victim()
            if v is not None and v in sub.blocks:
                self._evict(v, sub)
                return True
        return False

    def _evict(self, key: BlockKey, sub: SubStream, ghost: bool = True) -> None:
        size = sub.blocks.pop(key, 0)
        sub.policy.record_remove(key)
        self.block_sub.pop(key, None)
        self.used -= size
        self._mutations += 1
        if ghost:
            self.buffer_window.on_evict(key)
        self._on_evict(key, size)

    # -- quota management -------------------------------------------------------
    def set_quota(self, quota: int) -> None:
        grew = quota > self.quota
        self.quota = max(0, quota)
        self._mutations += 1
        if grew:
            # §4: on a size change, refresh pattern-derived decisions.
            self.stat_prefetch_done = False
            for sub in self.substreams.values():
                if isinstance(sub.policy, UniformCache):
                    sub.policy.mark_full(False)
        while self.used > self.quota:
            if not self._force_evict_one():
                break

    def _force_evict_one(self) -> bool:
        for sub in self.substreams.values():
            if isinstance(sub.policy, EagerEviction):
                v = sub.policy.choose_victim()
                if v is not None and v in sub.blocks:
                    self._evict(v, sub)
                    return True
        for sub in self.substreams.values():
            if isinstance(sub.policy, UniformCache):
                continue
            v = sub.policy.choose_victim()
            if v is not None and v in sub.blocks:
                self._evict(v, sub)
                return True
        for sub in self.substreams.values():
            v = sub.policy.force_victim()
            if v is not None and v in sub.blocks:
                self._evict(v, sub)
                return True
        return False

    def evict_all(self) -> int:
        """TTL expiry: drop the whole stream (the job is presumed finished)."""
        n = 0
        for sub in list(self.substreams.values()):
            for k in list(sub.blocks):
                self._evict(k, sub, ghost=False)
                n += 1
        return n


class UnifiedCache:
    """The shared cache pool: global residency map + CMU registry.

    Invariants (property-tested):
      * sum(cmu.used) == sum of sizes in the global map <= capacity;
      * sum(cmu.quota) == capacity (the default CMU absorbs slack);
      * each resident block belongs to exactly one CMU.
    """

    DEFAULT = ("<default>",)

    def __init__(self, capacity: int, cfg: Optional[CacheConfig] = None) -> None:
        self.capacity = capacity
        self.cfg = cfg or CacheConfig()
        self.stats = CacheStats()
        self.blocks: Dict[BlockKey, Tuple[int, CacheManageUnit]] = {}
        self.cmus: Dict[PathT, CacheManageUnit] = {}
        # bumped whenever the CMU registry changes; read-path caches of
        # path→CMU resolutions key their validity on it (§4 batched read)
        self.cmu_gen = 0
        # per-pool ghost-hit heat (core.sketch): every CMU's BufferWindow
        # sinks its ghost hits here so the cross-shard allocation round
        # can size unmet working sets from a bounded summary
        self.demand_sketch = DemandSketch(self.cfg)
        # optional eviction tap (key, size): a tiered backing store
        # registers its spill hook here (storage.tiers via IGTCache) —
        # observation only, never feeds back into kernel decisions
        self.evict_hook: Optional[Callable[[BlockKey, int], None]] = None
        self.default_cmu = CacheManageUnit(
            self.DEFAULT, capacity, self.cfg,
            on_evict=self._cmu_evicted, dataset_bytes=0)
        self.default_cmu.buffer_window.sink = self.demand_sketch.note
        self.cmus[self.DEFAULT] = self.default_cmu

    # -- bookkeeping hooks ------------------------------------------------------
    def _cmu_evicted(self, key: BlockKey, size: int) -> None:
        self.blocks.pop(key, None)
        self.stats.evictions += 1
        if self.evict_hook is not None:
            self.evict_hook(key, size)

    # -- queries ------------------------------------------------------------------
    def resident(self, key: BlockKey) -> bool:
        return key in self.blocks

    def used_bytes(self) -> int:
        return sum(c.used for c in self.cmus.values())

    def cmu_for_path(self, path: PathT) -> CacheManageUnit:
        """Deepest registered CMU whose root prefixes ``path`` (else default)."""
        for plen in range(len(path), 0, -1):
            cmu = self.cmus.get(path[:plen])
            if cmu is not None:
                return cmu
        return self.default_cmu

    # -- CMU lifecycle ----------------------------------------------------------
    def create_cmu(self, root_path: PathT, dataset_bytes: int,
                   now: float) -> CacheManageUnit:
        """Promote a newly non-trivial stream to its own CMU.

        Resident blocks under ``root_path`` migrate from the default CMU; the
        initial quota is the migrated footprint plus a fair slice of the
        default CMU's slack, never below ``min_share``.
        """
        existing = self.cmus.get(root_path)
        if existing is not None:
            return existing
        cmu = CacheManageUnit(root_path, 0, self.cfg,
                              on_evict=self._cmu_evicted,
                              dataset_bytes=dataset_bytes)
        cmu.buffer_window.sink = self.demand_sketch.note
        cmu.created_at = now
        prefix = path_key(root_path) + "/"
        moved_bytes = 0
        default = self.default_cmu
        for key in [k for k in default.block_sub if k.startswith(prefix)]:
            sub = default.block_sub[key]
            size = sub.blocks.pop(key)
            sub.policy.record_remove(key)
            default.block_sub.pop(key)
            default.used -= size
            dsub = cmu.substream(root_path, Pattern.UNKNOWN)
            dsub.blocks[key] = size
            dsub.policy.record_insert(key)
            cmu.block_sub[key] = dsub
            cmu.used += size
            self.blocks[key] = (size, cmu)
            moved_bytes += size
        if moved_bytes:
            default._mutations += 1
            cmu._mutations += 1
        slack = max(0, default.quota - default.used)  # post-move slack
        n_cmus = len(self.cmus)  # includes default
        desired = max(self.cfg.min_share, moved_bytes,
                      min(dataset_bytes, slack // max(1, n_cmus)))
        # default keeps a min-share floor (it adopts TTL-drained blocks and
        # serves unclassified traffic)
        grant = min(desired, max(0, default.quota - self.cfg.min_share))
        grant = max(grant, moved_bytes)       # must cover migrated residency
        default.set_quota(default.quota - grant)
        cmu.set_quota(grant)
        self.cmus[root_path] = cmu
        self.cmu_gen += 1
        return cmu

    def remove_cmu(self, root_path: PathT, transfer: bool = True) -> None:
        """TTL-expired job: release the stream back to the default pool.

        With ``transfer`` (default), resident blocks are *adopted* by the
        default CMU's LRU instead of being dropped eagerly: a genuinely
        finished job's data drains out as others claim space, while a
        misjudged-live job keeps hitting (and its blocks migrate back when
        its CMU is re-created).  Strictly dominates the paper's hard evict.
        """
        cmu = self.cmus.pop(root_path, None)
        if cmu is None or cmu is self.default_cmu:
            return
        self.cmu_gen += 1
        default = self.default_cmu
        default.set_quota(default.quota + cmu.quota)
        if transfer:
            for sub in list(cmu.substreams.values()):
                for key, size in list(sub.blocks.items()):
                    dsub = default.substream(root_path, Pattern.UNKNOWN)
                    dsub.blocks[key] = size
                    dsub.policy.record_insert(key)
                    default.block_sub[key] = dsub
                    default.used += size
                    self.blocks[key] = (size, default)
                sub.blocks.clear()
                default._mutations += 1
        else:
            cmu.evict_all()
        # default may now be over quota if capacity shrank elsewhere
        default.set_quota(default.quota)

    # -- cross-shard capacity (core.sharded) -------------------------------------
    def adjust_capacity(self, delta: int) -> None:
        """Grow or shrink this pool's capacity by ``delta`` bytes.

        Used by the cross-shard GlobalRebalancer: a quantum moving between
        shards shrinks the donor shard's pool and grows the taker's.  The
        caller is responsible for the paired CMU quota move (shrink the donor
        CMU before taking its capacity, grow the taker CMU after granting
        it), which keeps ``sum(quota) == capacity`` on both sides.
        """
        if self.capacity + delta < 0:
            raise ValueError(
                f"capacity adjustment {delta} would underflow pool "
                f"capacity {self.capacity}")
        self.capacity += delta

    # -- residency transitions -----------------------------------------------------
    def insert(self, path: PathT, size: int, cmu: CacheManageUnit,
               sub: SubStream) -> bool:
        return self.insert_key(path_key(path), size, cmu, sub)

    def insert_key(self, key: BlockKey, size: int, cmu: CacheManageUnit,
                   sub: SubStream) -> bool:
        """Hot-path insert for callers that already hold the block key."""
        ok = cmu.admit(key, size, sub)
        if ok:
            self.blocks[key] = (size, cmu)
        return ok

    def quota_invariant_ok(self) -> bool:
        return sum(c.quota for c in self.cmus.values()) <= self.capacity
