"""Parameter specification: shapes + logical axes + initializers (torch).

Counterpart of ``repro.models.params``.  A model is described as a nested
dict of ``ParamSpec``; the same tree materializes two ways:
  * ``tree_init(specs, generator)`` — real tensors on the generator's device,
    with the JAX init rule (normal × ``scale/sqrt(fan_in)``, zeros, ones);
  * ``tree_abstract(specs)`` — ``meta``-device tensors (shapes and dtypes,
    no allocation);
and ``tree_axes(specs)`` gives each leaf's logical axis names, which
``repro_torch.sharding.shardings_for`` maps onto a mesh.
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


def tree_unflatten(pairs) -> dict:
    """The nested dict of ``(path, leaf)`` pairs (``tree_leaves``'s
    inverse)."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_axes(specs):
    return tree_map(lambda s: s.axes, specs)


def tree_abstract(specs):
    return tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


# Largest f32 draw at once (1 GiB): a larger leaf is drawn in slices along
# its leading axis, straight into its output.
INIT_CHUNK = 2 ** 28


def tree_init(specs, generator: torch.Generator, device=None, each=None):
    """Materialize real parameters on ``device`` (default: the generator's).

    Leaves are drawn in JAX's flatten order from one generator, so the values
    depend only on the seed and the device's generator (not on JAX's).
    ``each(path, leaf)``, where given, takes each leaf as it is drawn and
    returns what the tree holds in its place (a rank's shard of it: the
    whole leaf is then freed before the next is drawn).  A
    normal leaf of more than ``INIT_CHUNK`` values is drawn in slices along
    its leading axis, each of at most ``INIT_CHUNK`` values (or one leading
    index), so that the f32 temporary stays small beside the output:
    qwen3-moe's expert stacks are 9.66 G values each."""
    device = torch.device(device) if device is not None else generator.device

    def init(spec):
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(1, fan_in))

        def draw(shape):
            return torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(std)
        if math.prod(spec.shape) <= INIT_CHUNK:
            return draw(spec.shape).to(spec.dtype)
        out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
        row = math.prod(spec.shape[1:])
        step = max(1, INIT_CHUNK // row)
        for i in range(0, spec.shape[0], step):
            part = out[i:i + step]
            part.copy_(draw(part.shape))
        return out
    keep = each or (lambda path, leaf: leaf)
    return tree_unflatten((path, keep(path, init(spec)))
                          for path, spec in tree_leaves(specs))
