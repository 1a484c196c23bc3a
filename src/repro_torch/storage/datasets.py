"""Dataset layout generators mirroring Table 1 of the paper.

Three storage granularities:
  * ``big_files``   — few large files, items smaller than a block
                      (BookCorpus: 74M records / 16 files; SQuAD: 1 file)
  * ``flat_files``  — one directory of many small files
                      (PASCAL-VOC, VoxForge, COCO images)
  * ``dir_tree``    — many directories each holding a subset of items
                      (ImageNet: 1k class dirs; ICOADS: 2k date dirs)

Layouts are metadata-only: file content is synthesized deterministically on
fetch, so a "400 GB" dataset costs a few dicts of metadata.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.types import MB, PathT


@dataclass
class FileEntry:
    path: PathT
    size: int


@dataclass
class DatasetSpec:
    """One dataset in the remote store."""

    name: str
    layout: str                      # big_files | flat_files | dir_tree
    files: List[FileEntry] = field(default_factory=list)
    # directory listing: parent path -> ordered child names
    dirs: Dict[PathT, List[str]] = field(default_factory=dict)
    total_bytes: int = 0
    n_items: int = 0                 # logical data items (records/images/...)

    def root(self) -> PathT:
        return (self.name,)


def make_dataset(name: str, layout: str, *,
                 n_files: int = 16, file_size: int = 512 * MB,
                 n_dirs: int = 0, files_per_dir: int = 0,
                 small_file_size: int = 128 * 1024,
                 n_items: Optional[int] = None) -> DatasetSpec:
    """Build a dataset layout.

    big_files:   ``<name>/data-{i:05d}.arrow`` × n_files, each ``file_size``.
    flat_files:  ``<name>/files/{i:07d}.bin`` × n_files, each small_file_size.
    dir_tree:    ``<name>/{d:05d}/{i:05d}.bin`` n_dirs × files_per_dir.
    """
    spec = DatasetSpec(name=name, layout=layout)
    root = (name,)
    if layout == "big_files":
        names = [f"data-{i:05d}.arrow" for i in range(n_files)]
        spec.dirs[root] = names
        for fn in names:
            spec.files.append(FileEntry(root + (fn,), file_size))
        spec.n_items = n_items or n_files * max(1, file_size // (16 * 1024))
    elif layout == "flat_files":
        sub = root + ("files",)
        spec.dirs[root] = ["files"]
        names = [f"{i:07d}.bin" for i in range(n_files)]
        spec.dirs[sub] = names
        for fn in names:
            spec.files.append(FileEntry(sub + (fn,), small_file_size))
        spec.n_items = n_items or n_files
    elif layout == "dir_tree":
        dnames = [f"{d:05d}" for d in range(n_dirs)]
        spec.dirs[root] = dnames
        for d in dnames:
            dpath = root + (d,)
            fnames = [f"{i:05d}.bin" for i in range(files_per_dir)]
            spec.dirs[dpath] = fnames
            for fn in fnames:
                spec.files.append(FileEntry(dpath + (fn,), small_file_size))
        spec.n_items = n_items or n_dirs * files_per_dir
    else:
        raise ValueError(f"unknown layout {layout!r}")
    spec.total_bytes = sum(f.size for f in spec.files)
    return spec
