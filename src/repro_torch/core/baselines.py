"""Named policy bundles used across the evaluation (§5).

Each bundle is an ``EngineOptions`` preset; "the baseline" in EXPERIMENTS.md
always means ``juicefs`` (enhanced-stride block readahead + one shared LRU
pool + fixed 600 s TTL — the vanilla-JuiceFS behaviour the paper compares
against; Alluxio ships effectively the same policies, §5.1).
"""
from __future__ import annotations

from typing import Optional

from .igtcache import EngineOptions
from .types import CacheConfig

BUNDLES = {
    # the paper's system
    "igtcache": EngineOptions(name="igtcache"),
    # production frameworks (≈ JuiceFS defaults / Alluxio)
    "juicefs": EngineOptions(prefetch="enhanced_stride", eviction="lru",
                             allocation="shared", fixed_ttl=600.0,
                             name="juicefs"),
    # §5.2 prefetch micro-benchmarks (everything else like juicefs-shared)
    "prefetch_stride": EngineOptions(prefetch="stride", eviction="lru",
                                     allocation="shared", name="prefetch_stride"),
    "prefetch_enhanced": EngineOptions(prefetch="enhanced_stride", eviction="lru",
                                       allocation="shared",
                                       name="prefetch_enhanced"),
    "prefetch_sfp": EngineOptions(prefetch="sfp", eviction="lru",
                                  allocation="shared", name="prefetch_sfp"),
    "prefetch_none": EngineOptions(prefetch="none", eviction="lru",
                                   allocation="shared", name="prefetch_none"),
    "prefetch_igt": EngineOptions(prefetch="adaptive", eviction="lru",
                                  allocation="shared", name="prefetch_igt"),
    # §5.3 eviction micro-benchmarks (no prefetch; per-job static 50 % quota)
    "evict_lru": EngineOptions(prefetch="none", eviction="lru",
                               allocation="static", name="evict_lru"),
    "evict_fifo": EngineOptions(prefetch="none", eviction="fifo",
                                allocation="static", name="evict_fifo"),
    "evict_arc": EngineOptions(prefetch="none", eviction="arc",
                               allocation="static", name="evict_arc"),
    "evict_uniform": EngineOptions(prefetch="none", eviction="uniform",
                                   allocation="static", name="evict_uniform"),
    "evict_sieve": EngineOptions(prefetch="none", eviction="sieve",
                                 allocation="static", name="evict_sieve"),
    "evict_lfu": EngineOptions(prefetch="none", eviction="lfu",
                               allocation="static", name="evict_lfu"),
    "evict_igt": EngineOptions(prefetch="none", eviction="adaptive",
                               allocation="static", name="evict_igt"),
    # §5.4 allocation micro-benchmarks (no prefetch; adaptive eviction)
    "alloc_shared": EngineOptions(prefetch="none", eviction="lru",
                                  allocation="shared", name="alloc_shared"),
    "alloc_quiver": EngineOptions(prefetch="none", eviction="adaptive",
                                  allocation="quiver", name="alloc_quiver"),
    "alloc_fluid": EngineOptions(prefetch="none", eviction="adaptive",
                                 allocation="fluid", name="alloc_fluid"),
    "alloc_igt": EngineOptions(prefetch="none", eviction="adaptive",
                               allocation="adaptive", name="alloc_igt"),
}


def bundle(name: str) -> EngineOptions:
    return BUNDLES[name]


def bundle_engine(name: str, meta, capacity: int,
                  cfg: Optional[CacheConfig] = None, n_shards: int = 1):
    """Construct a bare kernel running the named bundle, sharded when asked.

    Baselines ride the same sharded facade as IGTCache proper — the
    comparison in the evaluation stays apples-to-apples at any shard count
    (the global cross-shard rebalancer only activates for the adaptive
    allocation, exactly as the shard-local one does).
    """
    from .sharded import make_engine
    return make_engine(meta, capacity, cfg=cfg, options=bundle(name),
                       n_shards=n_shards)


def bundle_client(name: str, store, capacity: int,
                  cfg: Optional[CacheConfig] = None, n_shards: int = 1,
                  **client_kw):
    """``open_cache`` with a named policy bundle: the one constructor path
    (sim, benchmarks, examples) for baseline CacheClients."""
    from .client import open_cache
    return open_cache(store, capacity, cfg=cfg, options=bundle(name),
                      n_shards=n_shards, **client_kw)
