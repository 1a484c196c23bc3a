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
does.  ``restore`` takes no shardings until the sharding slice.
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
    """A tensor (or number) as NumPy on the host; bf16 as f32 (lossless)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


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

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
        self.wait()
        return self._write(step, self._snapshot(tree), extra)

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        """Snapshot to host, then write on a background thread."""
        self.wait()
        host = self._snapshot(tree)                 # device -> host copy
        t = threading.Thread(target=self._write, args=(step, host, extra),
                             daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

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

    def restore(self, tree_like: Any,
                step: Optional[int] = None) -> tuple[Any, dict]:
        """Restore into the structure of ``tree_like``: each leaf takes the
        dtype and device of the tensor in its place."""
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
        out = []
        for (_, like), arr in zip(flat_like, arrays):
            t = torch.from_numpy(arr.copy())      # 0-d stays 0-d
            if isinstance(like, torch.Tensor):
                t = t.to(device=like.device, dtype=like.dtype)
            out.append(t)
        return _unflatten_like(tree_like, iter(out)), manifest["extra"]
