"""Pluggable eviction policies (§3.3 + §5.3 baselines).

Adaptive selection per stream: sequential → eager, random → uniform caching,
skewed → LRU.  The classical policies (LRU/FIFO/LFU/ARC/SIEVE) are also
implemented both as baselines (§5.3) and as building blocks.

All policies speak a narrow interface driven by the CacheManageUnit:

    record_insert(key)      a block belonging to this stream entered the cache
    record_access(key, hit) a read was served (hit) or missed (miss)
    record_remove(key)      the block left the cache (any reason)
    admit(key) -> bool      may this new block enter at all? (uniform: no when full)
    choose_victim()         pick a block to evict to make room (None = refuse)
    force_victim()          pick a block when eviction is mandatory (quota shrink)

Policies track *keys only*; sizes/quotas live in the CacheManageUnit.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, Optional


class EvictionPolicy:
    name = "base"

    def __init__(self) -> None:
        self.resident: set[str] = set()

    # -- bookkeeping -------------------------------------------------------
    def record_insert(self, key: str) -> None:
        self.resident.add(key)

    def record_access(self, key: str, hit: bool) -> None:  # pragma: no cover
        pass

    def record_remove(self, key: str) -> None:
        self.resident.discard(key)

    # -- decisions ----------------------------------------------------------
    def admit(self, key: str) -> bool:
        return True

    def choose_victim(self) -> Optional[str]:  # pragma: no cover
        raise NotImplementedError

    def force_victim(self) -> Optional[str]:
        return self.choose_victim()

    def __len__(self) -> int:
        return len(self.resident)


class LRU(EvictionPolicy):
    name = "lru"

    def __init__(self) -> None:
        super().__init__()
        self._order: "OrderedDict[str, None]" = OrderedDict()

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._order[key] = None
        self._order.move_to_end(key)

    def record_access(self, key: str, hit: bool) -> None:
        if hit and key in self._order:
            self._order.move_to_end(key)

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        self._order.pop(key, None)

    def choose_victim(self) -> Optional[str]:
        if not self._order:
            return None
        return next(iter(self._order))


class FIFO(EvictionPolicy):
    name = "fifo"

    def __init__(self) -> None:
        super().__init__()
        self._queue: deque[str] = deque()

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._queue.append(key)

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        # lazy removal; choose_victim skips non-resident entries

    def choose_victim(self) -> Optional[str]:
        while self._queue:
            k = self._queue[0]
            if k in self.resident:
                return k
            self._queue.popleft()
        return None


class LFU(EvictionPolicy):
    """Frequency-ordered with LRU tie-break (O(1) bucket implementation)."""

    name = "lfu"

    def __init__(self) -> None:
        super().__init__()
        self._freq: Dict[str, int] = {}
        self._buckets: Dict[int, "OrderedDict[str, None]"] = {}
        self._min_freq = 0

    def _bucket(self, f: int) -> "OrderedDict[str, None]":
        return self._buckets.setdefault(f, OrderedDict())

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._freq[key] = 1
        self._bucket(1)[key] = None
        self._min_freq = 1

    def record_access(self, key: str, hit: bool) -> None:
        if not hit or key not in self._freq:
            return
        f = self._freq[key]
        bucket = self._buckets.get(f)
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket and self._min_freq == f:
                self._min_freq = f + 1
        self._freq[key] = f + 1
        self._bucket(f + 1)[key] = None

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        f = self._freq.pop(key, None)
        if f is not None:
            bucket = self._buckets.get(f)
            if bucket is not None:
                bucket.pop(key, None)

    def choose_victim(self) -> Optional[str]:
        if not self._freq:
            return None
        f = self._min_freq
        while f <= max(self._buckets, default=0):
            bucket = self._buckets.get(f)
            if bucket:
                self._min_freq = f
                return next(iter(bucket))
            f += 1
        # fallback: scan
        for f, bucket in sorted(self._buckets.items()):
            if bucket:
                return next(iter(bucket))
        return None


class ARC(EvictionPolicy):
    """Adaptive Replacement Cache (Megiddo & Modha, FAST'03).

    Entry-count based: ``capacity`` is the number of (roughly fixed-size)
    blocks the stream's quota admits.  T1 = recent-once, T2 = frequent,
    B1/B2 = ghost lists; p adapts toward whichever ghost list hits.
    """

    name = "arc"

    def __init__(self, capacity: int = 1024) -> None:
        super().__init__()
        self.capacity = max(1, capacity)
        self.p = 0.0
        self.t1: "OrderedDict[str, None]" = OrderedDict()
        self.t2: "OrderedDict[str, None]" = OrderedDict()
        self.b1: "OrderedDict[str, None]" = OrderedDict()
        self.b2: "OrderedDict[str, None]" = OrderedDict()

    def set_capacity(self, capacity: int) -> None:
        self.capacity = max(1, capacity)

    def record_access(self, key: str, hit: bool) -> None:
        if hit:
            if key in self.t1:
                del self.t1[key]
                self.t2[key] = None
            elif key in self.t2:
                self.t2.move_to_end(key)
            return
        # Miss path: ghost hits adapt p (the actual insert follows).
        if key in self.b1:
            self.p = min(float(self.capacity),
                         self.p + max(1.0, len(self.b2) / max(1, len(self.b1))))
            del self.b1[key]
            self._pending_t2 = key
        elif key in self.b2:
            self.p = max(0.0, self.p - max(1.0, len(self.b1) / max(1, len(self.b2))))
            del self.b2[key]
            self._pending_t2 = key

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        if getattr(self, "_pending_t2", None) == key:
            self.t2[key] = None
            self._pending_t2 = None
        else:
            self.t1[key] = None
        # bound ghost lists
        while len(self.b1) > self.capacity:
            self.b1.popitem(last=False)
        while len(self.b2) > self.capacity:
            self.b2.popitem(last=False)

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        self.t1.pop(key, None)
        self.t2.pop(key, None)

    def choose_victim(self) -> Optional[str]:
        if self.t1 and (len(self.t1) > self.p or not self.t2):
            k = next(iter(self.t1))
            self.b1[k] = None
            return k
        if self.t2:
            k = next(iter(self.t2))
            self.b2[k] = None
            return k
        if self.t1:
            k = next(iter(self.t1))
            self.b1[k] = None
            return k
        return None


class SIEVE(EvictionPolicy):
    """SIEVE (NSDI'24): FIFO queue + visited bit + moving hand."""

    name = "sieve"

    def __init__(self) -> None:
        super().__init__()
        self._order: "OrderedDict[str, bool]" = OrderedDict()  # key -> visited
        self._hand: Optional[str] = None

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._order[key] = False

    def record_access(self, key: str, hit: bool) -> None:
        if hit and key in self._order:
            self._order[key] = True

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        if self._hand == key:
            self._hand = self._prev_key(key)
        self._order.pop(key, None)

    def _prev_key(self, key: str) -> Optional[str]:
        prev = None
        for k in self._order:
            if k == key:
                return prev
            prev = k
        return None

    def choose_victim(self) -> Optional[str]:
        if not self._order:
            return None
        keys = list(self._order.keys())
        # hand starts at oldest (head) if unset
        try:
            idx = keys.index(self._hand) if self._hand in self._order else 0
        except ValueError:
            idx = 0
        n = len(keys)
        for step in range(2 * n):
            k = keys[idx % n]
            if self._order.get(k):
                self._order[k] = False
                idx += 1
            else:
                self._hand = keys[(idx + 1) % n] if n > 1 else None
                return k
        return keys[0]


class UniformCache(EvictionPolicy):
    """Uniform caching (§2.2, [58, 87]): pin-until-full, never thrash.

    Under a *random* access pattern every cached block has identical hit
    probability, so churn buys nothing; blocks are admitted until the quota is
    reached and never evicted thereafter (except mandatory quota shrink).
    """

    name = "uniform"

    def __init__(self) -> None:
        super().__init__()
        self._stack: list[str] = []
        self.full = False

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._stack.append(key)

    def record_remove(self, key: str) -> None:
        super().record_remove(key)

    def mark_full(self, full: bool) -> None:
        self.full = full

    def admit(self, key: str) -> bool:
        return not self.full

    def choose_victim(self) -> Optional[str]:
        return None  # never evict to admit

    def force_victim(self) -> Optional[str]:
        while self._stack:
            k = self._stack.pop()
            if k in self.resident:
                return k
        return None


class EagerEviction(EvictionPolicy):
    """Eager eviction for sequential streams (§3.3): evict right after use.

    The CacheManageUnit consults ``consumed()`` after each hit and evicts the
    block immediately — a sequentially-read block will not be read again.
    Prefetched-but-not-yet-read blocks are retained (they are the readahead
    window); victim order is FIFO if space is still needed.
    """

    name = "eager"

    def __init__(self) -> None:
        super().__init__()
        self._fifo: deque[str] = deque()
        self._used: set[str] = set()

    def record_insert(self, key: str) -> None:
        super().record_insert(key)
        self._fifo.append(key)

    def record_access(self, key: str, hit: bool) -> None:
        if hit:
            self._used.add(key)

    def record_remove(self, key: str) -> None:
        super().record_remove(key)
        self._used.discard(key)

    def mark_consumed(self, keys) -> None:
        """Blocks known to be behind the stream position (e.g. residents
        carried over from before the pattern switch)."""
        self._used.update(k for k in keys if k in self.resident)

    def consumed_victim(self) -> Optional[str]:
        for k in self._used:
            if k in self.resident:
                return k
        return None

    def evict_after_use(self, key: str) -> bool:
        return True

    def choose_victim(self) -> Optional[str]:
        # Prefer already-consumed blocks; otherwise sacrifice the *newest*
        # unread block (the far end of the readahead window) — the oldest
        # unread block is the very next one the stream will consume.
        for k in list(self._used):
            if k in self.resident:
                return k
        while self._fifo:
            k = self._fifo[-1]
            if k in self.resident:
                return k
            self._fifo.pop()
        return None


POLICIES = {
    "lru": LRU,
    "fifo": FIFO,
    "lfu": LFU,
    "arc": ARC,
    "sieve": SIEVE,
    "uniform": UniformCache,
    "eager": EagerEviction,
}


def make_policy(name: str, capacity_blocks: int = 1024) -> EvictionPolicy:
    cls = POLICIES[name]
    if cls is ARC:
        return ARC(capacity_blocks)
    return cls()
