"""Training-input pipeline that reads THROUGH the unified cache client.

This is the production integration of the paper's technique: every byte a
training/eval job consumes is requested from the unified cache via the
``CacheClient`` API, whose kernel observes the access stream, classifies
it (random for training epochs, sequential for eval sweeps) and adapts
prefetch/eviction/allocation accordingly.  No code intrusion above this
boundary — swap the client's engine for a baseline bundle and the model
code never knows.

Prefetch transport is the client's executor: the per-shard
``ThreadedExecutor`` for real training runs (background workers fetch
candidate bytes and complete them on the kernel; overflow/shutdown
*cancels* candidates instead of dropping them, and both outcomes are
visible in :class:`PipelineStats`), or the deterministic inline
``SimExecutor`` when ``background_prefetch=False`` (tests, virtual-clock
callers).

Token shards live in the (simulated) remote object store as big files;
sample i of a shard maps to a fixed byte range, so the cache sees the same
block-granular traffic a JuiceFS mount would.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Union

import numpy as np

from ..core.client import CacheClient, SimExecutor, ThreadedExecutor
from ..core.sharded import Engine
from ..core.types import MB, PathT, block_key
from ..storage.datasets import DatasetSpec, make_dataset
from ..storage.object_store import RemoteStore


def make_token_dataset(name: str, n_shards: int, shard_bytes: int) -> DatasetSpec:
    return make_dataset(name, "big_files", n_files=n_shards,
                        file_size=shard_bytes)


@dataclass
class PipelineStats:
    batches: int = 0
    bytes_read: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    # executor-side candidate accounting (the old PrefetchWorker lost
    # overflow cancels silently; now every candidate is either completed
    # or cancelled, and both show up here)
    prefetch_submitted: int = 0
    prefetch_completed: int = 0
    prefetch_cancelled: int = 0

    @property
    def hit_ratio(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 0.0


class CachedTokenPipeline:
    """Epoch-random LM batches served through the unified cache client."""

    def __init__(self, store: RemoteStore,
                 engine: Union[Engine, CacheClient], dataset: str,
                 *, seq_len: int, batch: int, vocab: int, seed: int = 0,
                 sample_bytes: Optional[int] = None,
                 background_prefetch: bool = True,
                 prefetch_queue_depth: int = 4096,
                 access_pattern: str = "random") -> None:
        self.store = store
        if isinstance(engine, CacheClient):
            self.client = engine
            self._own_client = False
        else:
            # one constructor path: candidates ride per-shard worker
            # threads (wall clock) or complete inline at the read's own
            # timestamp (deterministic, matches the caller-driven loop)
            executor = (ThreadedExecutor(queue_depth=prefetch_queue_depth)
                        if background_prefetch else SimExecutor())
            self.client = CacheClient(engine, backing=store,
                                      executor=executor)
            self._own_client = True
        self.engine = self.client.engine
        # per-pipeline attribution on a possibly shared client: report
        # executor counters as deltas from this construction point
        ex = self.client.executor.stats
        self._ex_base = (ex.submitted, ex.completed, ex.cancelled)
        self.dataset = store.datasets[dataset]
        self.seq_len = seq_len
        self.batch = batch
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.sample_bytes = sample_bytes or (seq_len + 1) * 4
        self.access_pattern = access_pattern
        self.stats = PipelineStats()
        self._samples = []
        for f in self.dataset.files:
            n = f.size // self.sample_bytes
            for i in range(n):
                self._samples.append((f.path, i * self.sample_bytes))

    def _account_outcome(self, out) -> None:
        self.stats.cache_hits += sum(1 for b in out.blocks if b.hit)
        self.stats.cache_misses += sum(1 for b in out.blocks if not b.hit)
        self.stats.bytes_read += self.sample_bytes
        self._sync_prefetch_stats()

    def _sync_prefetch_stats(self) -> None:
        ex = self.client.executor.stats
        base = self._ex_base
        self.stats.prefetch_submitted = ex.submitted - base[0]
        self.stats.prefetch_completed = ex.completed - base[1]
        self.stats.prefetch_cancelled = ex.cancelled - base[2]

    def _synth_tokens(self, fpath: PathT, offset: int) -> np.ndarray:
        # deterministic synthetic tokens for the sample's byte range
        block = offset // (4 * MB)
        raw = self.store.fetch_block(block_key(fpath, block),
                                     self.sample_bytes)
        tokens = raw.astype(np.int64)
        tokens = (tokens[0::4] * 16777619 + tokens[1::4] * 65537
                  + tokens[2::4] * 257 + tokens[3::4]) % self.vocab
        return tokens[: self.seq_len + 1].astype(np.int32)

    def _read_sample(self, fpath: PathT, offset: int) -> np.ndarray:
        res = self.client.read(fpath, offset, self.sample_bytes,
                               time.monotonic())
        self._account_outcome(res.outcome)
        return self._synth_tokens(fpath, offset)

    def batches(self, epochs: int = 1) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._samples))
        for _ in range(epochs):
            if self.access_pattern == "random":
                self.rng.shuffle(order)
            for i in range(0, len(order) - self.batch + 1, self.batch):
                group = [self._samples[j] for j in order[i:i + self.batch]]
                now = time.monotonic()
                # batched client path: the whole training batch goes
                # through the kernel in one call (tick cadence amortized
                # per batch); prefetch dispatch is the executor's job
                results = self.client.read_batch(
                    [(fp, off, self.sample_bytes) for fp, off in group], now)
                for res in results:
                    self._account_outcome(res.outcome)
                toks = [self._synth_tokens(fp, off) for fp, off in group]
                arr = np.stack(toks)
                self.stats.batches += 1
                yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait for in-flight background prefetches to land (tests /
        deterministic epoch boundaries)."""
        return self.client.flush(timeout)

    def close(self) -> None:
        if self._own_client:
            self.client.close()
        self._sync_prefetch_stats()
