"""Checkpointing with atomic commit, async save and restore (torch).

Counterpart of ``repro.train.checkpoint`` with the same on-disk layout, so a
checkpoint crosses between the packages both ways:

    <dir>/step_<N>/
        manifest.json       — step, time, extra, and per leaf its key, shape
                              and dtype
        shard_0.npz         — leaf_<i> for the i-th leaf
    <dir>/LATEST            — atomic pointer (rename commit)

Leaves are flattened in JAX's order (dict keys sorted; tuple and NamedTuple
fields in order) under JAX's ``keystr`` keys (``[0]['embed']``,
``[1].mu['blocks']['wq']``).  bf16 leaves are stored as f32 (npz cannot hold
bf16; the upcast is lossless) and cast back on restore, as the reference
does.  ``restore`` places each leaf by its sharding where given: on a
one-device mesh a plain tensor on the mesh's device, on a larger one a
DTensor with the sharding's placements, each rank keeping its own piece
of the file's full array.

A tree of DTensors (a step across ranks) is saved by every rank: each leaf's
``full_tensor()`` is a collective, rank 0 alone writes the files, and the
ranks meet at a barrier once they are written (``save``, or ``wait`` after
``save_async``), so a restore on any rank finds them.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .. import is_dtensor
from ..sharding.rules import mesh_size


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten_with_paths(v, f"{prefix}.{name}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten_like(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten_like(v, leaves) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_like(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    """A tensor (or number) as NumPy on the host; bf16 as f32 (lossless); a
    DTensor whole (a collective: every rank calls it)."""
    if isinstance(leaf, torch.Tensor):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _place(t: torch.Tensor, sharding) -> torch.Tensor:
    """``t`` placed by a ``sharding.NamedSharding``."""
    mesh = sharding.mesh
    on = getattr(mesh, "device_type", None)
    if on is not None:
        t = t.to(on)
    if mesh_size(mesh) == 1:
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, sharding.placements,
                             src_data_rank=None)


def _across_ranks(tree) -> bool:
    """Whether ``tree`` holds a DTensor (every rank saves it)."""
    return any(is_dtensor(v) for _, v in _flatten_with_paths(tree))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank()


def _barrier() -> None:
    import torch.distributed as dist
    dist.barrier()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._meet = False          # ranks meet at wait() (save_async)

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
        """Write ``tree`` as step ``step``; returns its directory.  Across
        ranks every rank calls it and returns once rank 0 has written."""
        self.wait()
        host = self._snapshot(tree)
        final = self.dir / f"step_{step:08d}"
        if not _across_ranks(tree):
            return self._write(step, host, extra)
        if _rank() == 0:
            self._write(step, host, extra)
        _barrier()
        return final

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        """Snapshot to host, then write on a background thread (across
        ranks: rank 0's; every rank then meets the others in ``wait``)."""
        self.wait()
        host = self._snapshot(tree)                 # device -> host copy
        self._meet = _across_ranks(tree)
        if self._meet and _rank() != 0:
            return
        t = threading.Thread(target=self._write, args=(step, host, extra),
                             daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._meet:
            self._meet = False
            _barrier()

    @staticmethod
    def _snapshot(tree) -> List[Tuple[str, str, np.ndarray]]:
        return [(k, _dtype_name(v), _to_host(v))
                for k, v in _flatten_with_paths(tree)]

    def _write(self, step: int, host, extra: Optional[dict]) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "leaves": [{"key": k, "shape": list(a.shape), "dtype": dt}
                       for k, dt, a in host],
        }
        np.savez(tmp / "shard_0.npz",
                 **{f"leaf_{i}": a for i, (_, _, a) in enumerate(host)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                            # atomic commit
        latest_tmp = self.dir / ".LATEST.tmp"
        latest_tmp.write_text(final.name)
        latest_tmp.rename(self.dir / "LATEST")
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(d for d in self.dir.iterdir()
                       if d.is_dir() and d.name.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        return int(ptr.read_text().strip().split("_")[-1])

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Restore into the structure of ``tree_like``: each leaf takes the
        dtype and device of the tensor in its place.  If ``shardings`` is
        given (a matching tree of ``NamedSharding``, ``None`` leaves kept
        where they are), each leaf is placed by its sharding — on any mesh,
        regardless of the mesh at save time."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "shard_0.npz") as data:
            arrays = [data[f"leaf_{i}"]
                      for i in range(len(manifest["leaves"]))]
        flat_like = _flatten_with_paths(tree_like)
        if len(flat_like) != len(arrays):
            raise ValueError(
                f"checkpoint has {len(arrays)} leaves, target structure has "
                f"{len(flat_like)} — incompatible trees")
        flat_sh = ([sh for _, sh in _flatten_with_paths(shardings)]
                   if shardings is not None else [None] * len(arrays))
        if len(flat_sh) != len(arrays):
            raise ValueError(f"shardings have {len(flat_sh)} leaves, the "
                             f"checkpoint {len(arrays)}")
        out = []
        for (_, like), arr, sh in zip(flat_like, arrays, flat_sh):
            t = torch.from_numpy(arr.copy())      # 0-d stays 0-d
            if isinstance(like, torch.Tensor):
                t = t.to(device=like.device, dtype=like.dtype)
            out.append(t if sh is None else _place(t, sh))
        return _unflatten_like(tree_like, iter(out)), manifest["extra"]
