"""IGTCache — the paper's primary contribution.

A unified, pattern/granularity-adaptive cache for heterogeneous AI workloads:
AccessStreamTree (§3.1) + K-S hypothesis-test pattern recognition (§3.2) +
adaptive prefetch/eviction/allocation (§3.3).

Public API is two layers (docs/API.md): the *kernel* (``IGTCache`` /
``ShardedIGTCache`` — a deterministic state machine driven with explicit
timestamps) and the *client* (``CacheClient`` via ``open_cache`` — owns
byte movement through a ``BackingStore`` and prefetch execution through a
``PrefetchExecutor``).
"""
from .access_stream_tree import (AccessStream, AccessStreamTree,
                                 ObservedChain, analyze_streams)
from .baselines import BUNDLES, bundle, bundle_client, bundle_engine
from .cache import CacheManageUnit, UnifiedCache, path_key
from .client import (BackingStore, CacheClient, ClientStats, ExecutorStats,
                     KernelGuard, NullExecutor, PrefetchExecutor, ReadResult,
                     SimExecutor, ThreadedExecutor, open_cache)
from .faults import (RestartBudget, SHARD_DOWN, SHARD_RESTARTING, SHARD_UP,
                     ShardUnavailableError)
from .igtcache import EngineOptions, IGTCache, ReadOutcome, informative_depth
from .ks import ks_critical, ks_test_random, triangular_cdf
from .meta import LevelCache
from .pattern import (PatternResult, classify, classify_batch,
                      detect_sequential, fit_adaptive_ttl,
                      fit_adaptive_ttl_batch)
from .procdriver import ProcessExecutor, ProcessShardedCache, ShmArena
from .sharded import (DemandSummary, GlobalRebalancer, ShardDemandTracker,
                      ShardRouting, ShardedIGTCache, make_engine,
                      shard_index, split_capacity)
from .types import (AccessRecord, CacheConfig, CacheStats, GB, MB, PathT,
                    Pattern, block_key, split_block_key)

__all__ = [
    "AccessRecord", "AccessStream", "AccessStreamTree", "BUNDLES",
    "BackingStore", "CacheClient", "CacheConfig", "CacheManageUnit",
    "CacheStats", "ClientStats", "DemandSummary", "EngineOptions",
    "ExecutorStats", "GB",
    "GlobalRebalancer", "IGTCache", "KernelGuard", "LevelCache", "MB",
    "NullExecutor", "ObservedChain",
    "PathT", "Pattern", "PatternResult", "PrefetchExecutor",
    "ProcessExecutor", "ProcessShardedCache", "ReadOutcome",
    "ReadResult", "RestartBudget", "SHARD_DOWN", "SHARD_RESTARTING",
    "SHARD_UP", "ShardDemandTracker", "ShardRouting", "ShardUnavailableError",
    "ShardedIGTCache",
    "ShmArena", "SimExecutor", "ThreadedExecutor",
    "UnifiedCache", "analyze_streams", "block_key", "bundle",
    "bundle_client", "bundle_engine", "classify",
    "classify_batch", "detect_sequential", "fit_adaptive_ttl",
    "fit_adaptive_ttl_batch", "informative_depth", "ks_critical",
    "ks_test_random", "make_engine", "open_cache", "path_key",
    "shard_index", "split_block_key", "split_capacity", "triangular_cdf",
]
