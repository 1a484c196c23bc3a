"""Parameter specification: shapes + logical axes + initializers (torch).

Counterpart of ``repro.models.params``.  A model is described as a nested
dict of ``ParamSpec``; the same tree materializes two ways:
  * ``tree_init(specs, generator)`` — real tensors on the generator's device,
    with the JAX init rule (normal × ``scale/sqrt(fan_in)``, zeros, ones);
  * ``tree_abstract(specs)`` — ``meta``-device tensors (shapes and dtypes,
    no allocation).
The logical axis names are kept for the sharding slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis names, len == ndim
    init: str = "normal"                   # normal | zeros | ones
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def p(shape, axes, init="normal", scale=1.0,
      dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn, tree):
    """Apply ``fn`` to every ``ParamSpec`` leaf of a nested dict."""
    if is_spec(tree):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def tree_leaves(tree, prefix=()):
    """``(path, leaf)`` pairs in JAX's flatten order (dict keys sorted)."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_leaves(tree[k], prefix + (k,))


def tree_abstract(specs):
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def tree_init(specs, generator: torch.Generator, device=None):
    """Materialize real parameters on ``device`` (default: the generator's).

    Leaves are drawn in JAX's flatten order from one generator, so the values
    depend only on the seed and the device's generator (not on JAX's)."""
    device = torch.device(device) if device is not None else generator.device
    out = {}
    for path, spec in tree_leaves(specs):
        if spec.init == "zeros":
            arr = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        elif spec.init == "ones":
            arr = torch.ones(spec.shape, dtype=spec.dtype, device=device)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale / math.sqrt(max(1, fan_in))
            arr = (torch.randn(spec.shape, generator=generator,
                               dtype=torch.float32, device=device)
                   .mul_(std).to(spec.dtype))
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return out

