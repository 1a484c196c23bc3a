"""LocalFSStore: the unified cache over a real directory tree (``file://``).

This is the adapter that turns the repo from simulator-only into a system
you can point at actual data: one walk of a directory snapshots its
geometry into the ``StoreMeta`` protocol the kernel observes (listings in
sorted order — the stable traversal-index space §3.2 needs), and the v2
``BackingStore`` surface serves real bytes with true ranged reads
(``seek`` + exact-length ``read``) and file-grouped batching (one open
per file per ``fetch_many`` call).

The snapshot is deliberate: datasets are immutable for the lifetime of a
run (the same assumption ``core.meta.LevelCache`` memoizes on).  Call
:meth:`refresh` — and ``engine.invalidate_meta_cache()`` — if the tree
changes mid-run.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

from ..core.types import MB, PathT
from .api import (BackingStore, RangeRequest, StoreCapabilities, StoreError,
                  StoreMetaIndex, TransientStoreError, register_scheme)

__all__ = ["LocalFSStore"]


class LocalFSStore(StoreMetaIndex, BackingStore):
    """Directory-tree store: sorted-listing metadata snapshot + ranged
    reads of the underlying files."""

    # the whole store state derives from the walked directory, so a
    # worker process can faithfully reconstruct it from the URI alone
    # (storage.api.store_spec → per-process re-open + re-negotiation)
    reopen_by_uri = True

    def __init__(self, root: str, block_size: int = 4 * MB) -> None:
        super().__init__()
        self.root = os.path.realpath(root)
        self.block_size = block_size
        if not os.path.isdir(self.root):
            raise StoreError(f"file://: not a directory: {self.root}")
        self.refresh()

    # -- snapshot walk -------------------------------------------------------
    def refresh(self) -> None:
        """(Re)walk the tree.  Listings hold sorted child names (dirs and
        files interleaved, as ``readdir`` order would be after sort), so
        child indices are stable across runs and processes."""
        self._files.clear()
        self._dirs.clear()
        self._index.clear()
        self._invalidate_derived()
        self._walk(())

    def _walk(self, rel: PathT) -> None:
        names: List[str] = []
        subdirs: List[str] = []
        files: List[tuple] = []
        with os.scandir(self._fs_path(rel)) as it:
            for entry in sorted(it, key=lambda e: e.name):
                if entry.is_dir(follow_symlinks=False):
                    names.append(entry.name)
                    subdirs.append(entry.name)
                elif entry.is_file(follow_symlinks=False):
                    names.append(entry.name)
                    files.append((entry.name, entry.stat().st_size))
        self._register_dir(rel, names)
        for name, size in files:
            self._register_file(rel + (name,), size)
        for name in subdirs:
            self._walk(rel + (name,))

    # -- path resolution -----------------------------------------------------
    def _fs_path(self, rel: PathT) -> str:
        for comp in rel:
            if not comp or comp in (".", "..") or os.sep in comp:
                raise StoreError(f"file://: invalid path component {comp!r}")
        return os.path.join(self.root, *rel)

    # -- BackingStore v2 -----------------------------------------------------
    def capabilities(self) -> StoreCapabilities:
        return StoreCapabilities(ranges=True, batching=True, concurrency=4)

    def fetch_range(self, path: PathT, offset: int,
                    length: int) -> np.ndarray:
        file_path, abs_off = self._absolute_range(path, offset, length)
        return self._read(file_path, abs_off, length)

    def fetch_many(self, requests: Sequence[RangeRequest]
                   ) -> List[np.ndarray]:
        """File-grouped batch: requests touching the same file share one
        open file descriptor (results stay in request order)."""
        resolved = [self._absolute_range(p, o, n) + (n,)
                    for p, o, n in requests]
        out: List[np.ndarray] = [None] * len(resolved)  # type: ignore
        by_file: dict = {}
        for i, (fpath, off, length) in enumerate(resolved):
            by_file.setdefault(fpath, []).append((i, off, length))
        for fpath, group in by_file.items():
            with self._open(fpath) as f:
                for i, off, length in group:
                    out[i] = self._read_fd(f, fpath, off, length)
        return out

    # -- I/O helpers ---------------------------------------------------------
    def _open(self, file_path: PathT):
        fs = self._fs_path(file_path)
        try:
            return open(fs, "rb")
        except FileNotFoundError as e:
            raise StoreError(f"file://: no such file: {fs}") from e
        except OSError as e:
            raise TransientStoreError(f"file://: open failed: {fs}: {e}") \
                from e

    def _read(self, file_path: PathT, offset: int,
              length: int) -> np.ndarray:
        with self._open(file_path) as f:
            return self._read_fd(f, file_path, offset, length)

    def _read_fd(self, f, file_path: PathT, offset: int,
                 length: int) -> np.ndarray:
        if length <= 0:
            return np.empty(0, dtype=np.uint8)
        try:
            f.seek(offset)
            data = f.read(length)
        except OSError as e:
            raise TransientStoreError(
                f"file://: read failed: {'/'.join(file_path)}: {e}") from e
        if len(data) != length:
            # metadata snapshot and file disagree — the tree changed
            # underneath us; that is a caller problem, not a retry case
            raise StoreError(
                f"file://: short read on {'/'.join(file_path)}: wanted "
                f"[{offset}, {offset + length}), got {len(data)} bytes "
                f"(tree changed since the snapshot? call refresh())")
        return np.frombuffer(data, dtype=np.uint8)


def _file_factory(url, **params):
    # file:///abs/dir → ('', '/abs/dir'); file://rel/dir → ('rel', '/dir');
    # plain concatenation reassembles both (join would drop the netloc
    # in front of an absolute path)
    from urllib.parse import unquote
    return LocalFSStore(unquote(url.netloc + url.path), **params)


register_scheme("file", _file_factory)
