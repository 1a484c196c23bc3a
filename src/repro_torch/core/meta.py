"""Metadata protocol the cache core needs from the storage layer.

The core never imports ``repro.storage`` — any object satisfying this
protocol (the simulated S3 store, a real filesystem walker, the training-data
shard store) can back IGTCache.
"""
from __future__ import annotations

from typing import Iterator, List, Protocol, Tuple

from .types import PathT


class StoreMeta(Protocol):
    """Listing/geometry metadata (what a FUSE layer sees from readdir/stat)."""

    def listing(self, path: PathT) -> List[str]:
        """Ordered child names under ``path`` (traversal order — the index
        space of §3.2)."""
        ...

    def listing_size(self, path: PathT) -> int:
        """len(listing(path)) without materializing it."""
        ...

    def child_index(self, path: PathT, name: str) -> int:
        """Position of ``name`` in ``listing(path)``."""
        ...

    def is_file(self, path: PathT) -> bool:
        ...

    def file_size(self, path: PathT) -> int:
        ...

    def subtree_bytes(self, path: PathT) -> int:
        """Total bytes stored under ``path`` (dataset size for §3.3)."""
        ...

    def iter_block_keys(self, path: PathT) -> Iterator[Tuple[PathT, int]]:
        """All (block_path, size) under ``path`` in traversal order."""
        ...

    def flat_block_index(self, file_path: PathT, block: int) -> Tuple[int, int]:
        """(global block ordinal, total blocks) within the file's top-level
        dataset, in traversal order — the flattened index space used for
        dataset-granularity pattern analysis."""
        ...


class LevelCache:
    """Memoized root→leaf level resolution over a StoreMeta (§4).

    The seed engine re-asked the store for ``listing_size``/``child_index``
    at every directory level of every block access.  Listings are static for
    the lifetime of a run (datasets are immutable once registered), so the
    (name, index, listing-size) decomposition of a path is a pure function of
    the path — memoize it per directory, sharing the common prefix across
    all files in that directory.  Call :meth:`invalidate` if the backing
    store ever re-registers datasets mid-run.
    """

    # Bound on memoized paths: entries are tiny (one tuple-of-tuples per
    # path) but a process streaming over millions of distinct files must not
    # grow without limit; on overflow the cache simply resets (a rebuild
    # costs a handful of dict lookups per path).
    MAX_ENTRIES = 1 << 20

    def __init__(self, meta: StoreMeta, max_entries: int = MAX_ENTRIES) -> None:
        self._meta = meta
        self._max = max_entries
        self._dirs: dict = {(): ()}

    def dir_levels(self, path: PathT) -> Tuple[Tuple[str, int, int], ...]:
        """(name, child-index, parent-listing-size) for each component."""
        got = self._dirs.get(path)
        if got is None:
            parent, name = path[:-1], path[-1]
            got = self.dir_levels(parent) + (
                (name, self._meta.child_index(parent, name),
                 self._meta.listing_size(parent)),)
            if len(self._dirs) >= self._max:
                self._dirs = {(): ()}
            self._dirs[path] = got
        return got

    def invalidate(self) -> None:
        self._dirs = {(): ()}
