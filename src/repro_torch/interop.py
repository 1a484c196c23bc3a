"""Parameter trees across the framework boundary, through NumPy.

The JAX package's parameter tree (nested dicts, stacked ``(L, ...)`` layer
arrays) arrives as NumPy arrays and leaves as NumPy arrays, with the same
names and shapes.  bf16 crosses as its 16-bit pattern: ``torch.from_numpy``
rejects ml_dtypes' ``bfloat16``, so such a leaf is viewed as ``int16``, wrapped
and viewed back as ``torch.bfloat16`` — bit-exact both ways.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")     # writable, owned by torch
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_tree, device) -> dict:
    """JAX parameter tree (NumPy leaves) -> the port's tensors on ``device``."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    return _leaf_to_torch(np_tree, device)


def params_to_numpy(state) -> dict:
    """The port's tensors -> NumPy leaves; bf16 leaves come back as their
    ``uint16`` bit pattern (view them as ``ml_dtypes.bfloat16`` to use them
    as numbers)."""
    if isinstance(state, dict):
        return {k: params_to_numpy(v) for k, v in state.items()}
    t = state.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


__all__ = ["params_from_jax", "params_to_numpy"]
