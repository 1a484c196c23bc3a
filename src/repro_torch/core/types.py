"""Core datatypes for IGTCache.

The vocabulary follows the paper (§3): an *access* is one block-granular read
observed at the cache; an *AccessStream* groups accesses sharing a path prefix;
a *pattern* is one of {sequential, random, skewed} (plus unknown before the
observation window fills).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable, Optional, Tuple

# Path components are strings; a full block key is the file path plus a block
# ordinal, e.g. ("ImageNet", "train", "n01491361", "4716.JPEG", "#0").
PathT = Tuple[str, ...]

MB = 1024 * 1024
GB = 1024 * MB


def block_key(path: PathT, idx: int) -> PathT:
    """Block path for block ``idx`` of file ``path``.

    The one place the ``"#<n>"`` leaf convention is constructed — every
    layer (client fetch paths, token pipeline, store block enumeration)
    builds block paths through here so the convention cannot drift.
    """
    return path + (f"#{idx}",)


def split_block_key(path: PathT) -> Tuple[PathT, Optional[int]]:
    """Inverse of :func:`block_key`: ``(file_path, block_idx)``.

    A path without a ``"#<n>"`` leaf returns ``(path, None)`` — callers
    that accept both file and block paths branch on the second element.
    A leaf that merely *starts* with ``#`` (a real file can be named
    ``"#notes"``) is not a block key either.
    """
    if path and path[-1][:1] == "#":
        try:
            return path[:-1], int(path[-1][1:])
        except ValueError:
            return path, None
    return path, None


class Pattern(enum.Enum):
    UNKNOWN = "unknown"
    SEQUENTIAL = "sequential"
    RANDOM = "random"
    SKEWED = "skewed"


@dataclass(frozen=True)
class AccessRecord:
    """One observed access at a specific tree level.

    ``index`` is the data-item index of the touched child within its parent
    (block id for blocks; listing position for files/directories — the
    "sequential element number in the parent directory" of §3.2).
    ``total`` is the number of items at that level (c in the paper's PMF).
    """

    index: int
    total: int
    time: float
    child_key: str
    size: int = 0


@dataclass
class CacheConfig:
    """Hyper-parameters, defaults exactly as published (§4, §5.1)."""

    # §3.1 — observation window (accesses per stream kept for analysis).
    window: int = 100
    # §3.2 — K-S significance level.
    alpha: float = 0.01
    # Fraction of unit-stride gaps required to call a stream sequential.
    sequential_threshold: float = 0.8
    # z-score threshold for the distinct-count (frequency-skew) screen.
    distinct_z_threshold: float = 3.0
    # Adaptive readahead: depth starts at prefetch_depth and doubles while the
    # stream stays sequential, up to this many items per generation.
    max_readahead_items: int = 512
    # §3.3 — prefetch depth N for sequential streams.
    prefetch_depth: int = 4
    # §3.3 — hot-child probability threshold f_p for hierarchical prefetch.
    f_p: float = 0.8
    # §3.3 — statistical prefetching: prefetch whole dataset when the expected
    # hit ratio (= allocatable cache / dataset size) clears this threshold.
    statistical_prefetch_threshold: float = 0.8
    # §3.3 — BufferWindow (ghost cache) size in blocks, w.
    buffer_window: int = 100
    # Cap on bytes one sequential/hierarchical prefetch generation may cover
    # (admission may still evict stale blocks to make room; this only bounds
    # the readahead horizon so one stream cannot monopolize the link).
    prefetch_budget_bytes: int = 256 * MB
    # §3.3 — adaptive TTL: significance + base time (seconds).
    ttl_significance: float = 0.01
    ttl_base: float = 60.0
    # §4 — allocation rebalance cadence and quantum.
    rebalance_period: float = 60.0
    rebalance_quantum: int = 640 * MB
    min_share: int = 640 * MB
    # §4 — AccessStreamTree node cap (LRU beyond this).
    node_cap: int = 10_000
    # Block size used by the cache layer (JuiceFS default, §5.2).
    block_size: int = 4 * MB
    # Re-run pattern analysis every this many accesses after non-trivial.
    reanalyze_every: int = 50
    # Cross-shard demand sketches (core/sketch.py): CountMinSketch geometry
    # for the per-shard ghost-hit heat summary, and the SpaceSaving top-k
    # capacity (also caps exact per-CMU rows in a shard's wire summary).
    sketch_width: int = 512
    sketch_depth: int = 3
    topk: int = 64
    # Cross-shard move sizing: "adaptive" sizes each move by the taker's
    # measured unmet demand (sketch-derived) with gap/shard-count-scaled
    # caps on forced-eviction transfers; "fixed" is the legacy
    # one-quantum-per-move greedy loop.
    quantum_policy: str = "adaptive"


@dataclass
class CacheStats:
    """Counters maintained by the engine; CHR is block-level (§5.1)."""

    hits: int = 0
    misses: int = 0
    prefetch_hits: int = 0  # hits served by a block brought in via prefetch
    bytes_from_cache: int = 0
    bytes_from_remote: int = 0
    evictions: int = 0
    prefetch_issued: int = 0
    prefetch_wasted: int = 0  # prefetched blocks evicted before any hit

    @property
    def accesses(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        n = self.accesses
        return self.hits / n if n else 0.0

    def merge(self, other: "CacheStats") -> "CacheStats":
        """Accumulate another engine's counters (shard-mergeable stats: the
        ShardedIGTCache facade sums its shards' CacheStats into one view).
        Iterates the dataclass fields so counters added later merge too."""
        import dataclasses
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other,
                                                                  f.name))
        return self

    @classmethod
    def merged(cls, parts: "Iterable[CacheStats]") -> "CacheStats":
        out = cls()
        for p in parts:
            out.merge(p)
        return out

    def snapshot(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": self.hit_ratio,
            "prefetch_hits": self.prefetch_hits,
            "bytes_from_cache": self.bytes_from_cache,
            "bytes_from_remote": self.bytes_from_remote,
            "evictions": self.evictions,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_wasted": self.prefetch_wasted,
        }
