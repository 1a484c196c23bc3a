"""The storage layer: URI-addressed stores behind one v2 protocol.

``open_store(uri)`` is the front door — ``sim://`` (simulated S3-style
object store), ``file:///dir`` (real directory tree), ``mem://``
(in-memory test store), ``s3://host:port/bucket`` (ranged HTTP object
store, with ``mock-s3://`` as its deterministic in-process double),
``tiered+<scheme>://`` (RAM + spill-to-disk tiers with pattern-aware
placement), ``faulty+<scheme>://`` (seeded fault injection).
All of them satisfy ``core.meta.StoreMeta`` for the kernel and the
ranged/batched ``BackingStore`` v2 protocol for the client; legacy
one-method ``fetch_block`` stores keep working through
``as_backing_store``.  See docs/API.md "Storage API" and "Tiered
storage".
"""
from .api import (BackingStore, CircuitBreaker, CircuitOpenError,
                  DeadlineError, FaultyStore, LegacyStoreAdapter, MemStore,
                  RetryPolicy, StoreCapabilities, StoreError, StoreMetaIndex,
                  TransientStoreError, as_backing_store, open_store,
                  register_scheme, registered_schemes)
from .datasets import DatasetSpec, make_dataset
from .local_fs import LocalFSStore
from .object_store import ObjectStoreSim, RemoteStore, TransferModel
from .s3 import MockS3Server, S3Store
from .tiers import DiskTier, TieredStore, TierStats

__all__ = [
    "BackingStore", "CircuitBreaker", "CircuitOpenError", "DatasetSpec",
    "DeadlineError", "DiskTier", "FaultyStore", "LegacyStoreAdapter",
    "LocalFSStore", "MemStore", "MockS3Server", "ObjectStoreSim",
    "RemoteStore", "RetryPolicy", "S3Store", "StoreCapabilities",
    "StoreError", "StoreMetaIndex", "TieredStore", "TierStats",
    "TransferModel", "TransientStoreError", "as_backing_store",
    "make_dataset", "open_store", "register_scheme", "registered_schemes",
]
