"""Logical-axis -> mesh-axis sharding rules (MaxText-style), for torch.

Counterpart of ``repro.sharding.rules``.  Params and activations carry
*logical* axis names ("embed", "heads", "ffn", "experts", "batch", "seq",
...); a rules table maps each to zero or more mesh axes.  Hillclimbing a
sharding scheme = editing one table (``launch.variants``).

Divisibility fallback: if a dimension is not divisible by the mapped mesh
axes' product (e.g. 4 KV heads on a 16-way model axis), the mapping is
dropped for that dim (replicated) rather than failing.  A mesh axis shards
at most one dim of an array.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``shape`` a tuple,
``mesh_dim_names`` its axis names), or any object whose ``shape`` is a dict
of axis name -> size, as a JAX mesh's is; ``mesh_axes`` turns either into
the dict.  A spec is a ``P``: per array dimension ``None``, one mesh axis
name or a tuple of them, as JAX's ``PartitionSpec`` holds it.
``NamedSharding(mesh, spec).placements`` gives DTensor's placements: per
mesh dimension ``Shard(d)`` for the array dimension ``d`` it shards, else
``Replicate()``.  ``distribute_tree`` places a tree by such shardings, as
``jax.device_put(tree, shardings)`` does; ``distribute_inputs`` places a
step's inputs by their logical axes (``INPUT_AXES``); ``CACHE_AXES`` names
a decode state's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..models.params import tree_map

AxisMap = Union[str, Tuple[str, ...], None]
LogicalRules = Dict[str, AxisMap]

# The production mesh axes: ("pod",) "data", "model".
#   pod+data — DP/FSDP; model — TP/EP.
DEFAULT_RULES: LogicalRules = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv": None,
    "act_ffn": "model",
    "act_experts": "model",
    "act_vocab": "model",
    "moe_capacity": None,     # variant ep_capacity → "data"
    "cache_seq": None,
    "cache_batch": ("pod", "data"),
    # params: TP axis
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    "embed_vocab": "model",   # the embedding table's vocab dim (gather side)
    # params: FSDP axis (the non-TP big dim of each matrix)
    "embed": "data",
    "embed_noshard": None,
    # stacked-layer dim and small vectors
    "layers": None,
    "norm": None,
    "conv": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
}


class P(tuple):
    """A partition spec: one entry per array dimension (``None``, a mesh
    axis name, or a tuple of them), compared as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """The mesh's axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    if isinstance(getattr(mesh, "shape", None), dict):
        return dict(mesh.shape)
    raise TypeError(f"{type(mesh).__name__} is not a mesh: it needs "
                    "mesh_dim_names, or a shape dict of axis -> size")


def mesh_size(mesh) -> int:
    """The number of devices the mesh spans."""
    return math.prod(mesh_axes(mesh).values())


def _mesh_axes_size(shape: Dict[str, int], amap: AxisMap) -> int:
    if amap is None:
        return 1
    axes = (amap,) if isinstance(amap, str) else amap
    size = 1
    for a in axes:
        size *= shape.get(a, 1)
    return size


def _present(shape: Dict[str, int], amap: AxisMap) -> AxisMap:
    """Drop mesh axes that don't exist in this mesh (e.g. 'pod' single-pod)."""
    if amap is None:
        return None
    axes = (amap,) if isinstance(amap, str) else tuple(amap)
    axes = tuple(a for a in axes if a in shape)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def apply_rules(axes: Sequence[Optional[str]], shape: Sequence[int],
                mesh, rules: Optional[LogicalRules] = None,
                used_ok: bool = False) -> P:
    """Logical axes of one array → P, with divisibility/duplicate fallback
    (an axis may shard at most one dim)."""
    rules = rules or DEFAULT_RULES
    msh = mesh_axes(mesh)
    spec = []
    used: set = set()
    for dim, name in zip(shape, axes):
        amap = _present(msh, rules.get(name)) if name else None
        if amap is not None:
            flat = (amap,) if isinstance(amap, str) else tuple(amap)
            if any(a in used for a in flat) or \
                    dim % _mesh_axes_size(msh, flat) != 0:
                amap = None
            else:
                used.update(flat)
        spec.append(amap)
    return P(*spec)


@dataclass(frozen=True)
class NamedSharding:
    """An array's placement on a mesh: ``spec`` names, per array dimension,
    the mesh axes that shard it."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension in mesh order."""
        from torch.distributed.tensor import Replicate, Shard
        by_axis = {}
        for d, entry in enumerate(self.spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                by_axis[a] = Shard(d)
        return tuple(by_axis.get(a, Replicate())
                     for a in mesh_axes(self.mesh))

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of an array of ``shape`` (ceiling division,
        as DTensor's ``Shard`` chunks a dimension)."""
        msh = mesh_axes(self.mesh)
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(-(-dim // _mesh_axes_size(msh, entry))
                     for dim, entry in zip(shape, spec))


def logical_sharding(axes: Sequence[Optional[str]], shape: Sequence[int],
                     mesh, rules: Optional[LogicalRules] = None
                     ) -> NamedSharding:
    return NamedSharding(mesh, apply_rules(axes, shape, mesh, rules))


def shardings_for(specs, mesh, rules: Optional[LogicalRules] = None):
    """Tree of ParamSpec → tree of NamedSharding."""
    return tree_map(lambda s: logical_sharding(s.axes, s.shape, mesh, rules),
                    specs)


def distribute_tree(tree, shardings):
    """Each tensor leaf of ``tree`` (nested dicts, tuples, NamedTuples)
    as a DTensor on its ``NamedSharding``'s mesh and placements; a Python
    number becomes a 0-d tensor first (a decode state's ``pos``: int32), a
    DTensor is redistributed, ``None`` stays.  Every rank holds the same
    full tensor (the seed's weights, the global batch) and keeps its own
    piece of it (``src_data_rank=None``): nothing is broadcast.  The
    result never shares memory with ``tree`` (an update in place of a
    distributed param leaves the caller's tensor as it was).  On a mesh
    without ranks (torch's fake group, whose steps run on ``meta``
    DTensors) a Python number stays as it is: its device may not exist
    here (the dry-run counts on a "cuda" mesh without a card)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [distribute_tree(v, s) for v, s in zip(tree, shardings)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else tuple(parts)
    if tree is None:
        return None
    mesh, placements = shardings.mesh, shardings.placements
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, placements)
    if not isinstance(tree, torch.Tensor):
        from .context import has_ranks
        if not has_ranks(mesh):
            return tree
        tree = torch.tensor(tree, dtype=torch.int32)
    tree = tree.to(mesh.device_type)
    out = distribute_tensor(tree, mesh, placements, src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().data_ptr() == \
            tree.untyped_storage().data_ptr():
        # a replicated (or leading-dim) piece is a view of the caller's
        # tensor: own it, as device_put's result does
        out = DTensor.from_local(local.clone(), mesh, placements,
                                 run_check=False, shape=out.shape,
                                 stride=out.stride())
    return out


# the logical axes of a step's inputs, by name (the reference's
# batch_shardings)
INPUT_AXES = {
    "labels": ("batch", "seq"),
    "tokens": ("batch", "seq"),
    "inputs_embeds": ("batch", "seq", "act_embed"),
    "img_embeds": ("batch", "seq", "act_embed"),
}

# the logical axes of a decode state's leaves, by name (the reference's
# serve_step.CACHE_AXES; the model places a vlm's image K/V by them too)
CACHE_AXES = {
    "pos": (),
    "k": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
    "conv": ("layers", "cache_batch", None, "ssm_inner"),
    "ssd": ("layers", "cache_batch", "ssm_heads", None, None),
    "shared_k": (None, "cache_batch", "cache_seq", "kv_heads", None),
    "shared_v": (None, "cache_batch", "cache_seq", "kv_heads", None),
    "img_kv": (None, "cache_batch", None, "kv_heads", None),
}


def distribute_inputs(inputs, mesh, rules: Optional[LogicalRules] = None):
    """A step's inputs by name (the same global tensors on every rank) as
    DTensors placed by ``INPUT_AXES`` under ``rules``."""
    return distribute_tree(inputs, {k: logical_sharding(
        INPUT_AXES[k], v.shape, mesh, rules) for k, v in inputs.items()})
