"""The simulated remote object store + transfer cost model (``sim://``).

Implements the ``repro.core.meta.StoreMeta`` protocol for IGTCache (via
the shared :class:`~repro.storage.api.StoreMetaIndex`) and a shared-link
transfer model calibrated to the paper's testbed (§5.1): ~150 ms request
latency, ~1 Gbps aggregate remote bandwidth.  The link is a single FIFO
resource — concurrent jobs and background prefetches contend for it,
which is exactly the effect the hierarchical-prefetch experiment
(Fig. 7/9) depends on.

Content is synthesized deterministically from the block key (for the real
training pipeline); the simulator only uses sizes/latencies.  Synthesis
is the v2 ranged path: a per-file blake2b seed is hashed **once** and
cached (the old code rebuilt a digest and a ``default_rng`` per block on
the hot demand path), and bytes come from a counter-based generator
(``api.synth_range``) so any sub-range materializes directly —
``fetch_range(p, o, n) == fetch_block(p, o+n)[o:]`` without generating
the prefix.  ``benchmarks/store_micro.py`` asserts synthesis stays far
under the simulated transfer time, so the sim's cost model, not content
generation, dominates any measured run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..core.types import PathT
from .api import (BackingStore, StoreCapabilities, StoreMetaIndex,
                  path_seed, register_scheme, synth_range)
from .datasets import DatasetSpec


@dataclass
class TransferModel:
    """Shared remote link: latency + bandwidth, FIFO service."""

    latency_s: float = 0.150          # paper: ~150 ms to S3
    bandwidth_Bps: float = 125e6      # paper: ~1 Gbps
    # local cache service (DRAM/SSD over NFS) — effectively free vs remote
    local_latency_s: float = 0.0005
    local_bandwidth_Bps: float = 6e9

    def remote_time(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_Bps

    def local_time(self, nbytes: int) -> float:
        return self.local_latency_s + nbytes / self.local_bandwidth_Bps


class RemoteStore(StoreMetaIndex, BackingStore):
    """Dataset registry + metadata resolution + content synthesis."""

    def __init__(self, transfer: Optional[TransferModel] = None) -> None:
        super().__init__()
        self.datasets: Dict[str, DatasetSpec] = {}
        self.transfer = transfer or TransferModel()
        # hoisted digest state: one blake2b per *file*, reused by every
        # block-level fetch of that file (the demand hot path)
        self._seed_cache: Dict[PathT, int] = {}

    # -- registry -------------------------------------------------------------
    def add(self, spec: DatasetSpec) -> None:
        self.datasets[spec.name] = spec
        for f in spec.files:
            self._register_file(f.path, f.size)
        for parent, names in spec.dirs.items():
            self._register_dir(parent, names)
        # root listing across datasets
        self._register_dir((), sorted(self.datasets.keys()))
        self._invalidate_derived()

    # -- content (BackingStore v2) --------------------------------------------
    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities(ranges=True, batching=False, concurrency=8)

    def _file_seed(self, file_path: PathT) -> int:
        seed = self._seed_cache.get(file_path)
        if seed is None:
            seed = path_seed(file_path)
            self._seed_cache[file_path] = seed
        return seed

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        """Deterministic synthetic bytes for any sub-range — generated
        directly, no prefix over-synthesis.  Each file is one content
        stream seeded by its path; a block path is resolved to the
        absolute file offset (``StoreMetaIndex._absolute_range``), so
        file-path and block-path addressing return identical bytes —
        the same coherence contract the real stores keep."""
        file_path, abs_off = self._absolute_range(path, offset, length)
        return synth_range(self._file_seed(file_path), abs_off, length)

    def fetch_block(self, path: PathT, size: int) -> np.ndarray:
        """Legacy v1 surface: first ``size`` bytes of the block at
        ``path`` (kept verbatim — third-party callers and the token
        pipeline address content this way)."""
        return self.fetch_range(path, 0, size)


# The class is the repo's object-store *simulator*; the alias names it as
# such where the distinction matters (the ``faulty+sim://`` wrapper docs).
ObjectStoreSim = RemoteStore


def _sim_factory(url, **params):
    transfer_keys = ("latency_s", "bandwidth_Bps", "local_latency_s",
                     "local_bandwidth_Bps")
    transfer_kw = {k: params.pop(k) for k in transfer_keys if k in params}
    if params:
        raise ValueError(f"sim://: unknown parameters {sorted(params)}")
    return RemoteStore(TransferModel(**transfer_kw))


register_scheme("sim", _sim_factory)
