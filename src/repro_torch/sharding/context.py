"""Ambient activation-sharding context (torch).

Counterpart of ``repro.sharding.context``.  Model code calls
``constrain(x, ("batch", "seq", "act_embed"))``; when a (mesh, rules)
context is active (set by the train/serve step builders), a DTensor is
redistributed to the placements the rules give it, and a plain tensor
passes through unchanged as long as every mesh axis has size 1 (a one-device
mesh: the placements could only say "replicated").  Outside a context it is
a no-op (CPU tests, plain eager use).

On a ``DeviceMesh`` of more than one rank (``launch.mesh.make_mesh``) the
steps run with DTensor params, batch and decode state, and a plain tensor
reaching ``constrain`` raises: a step's inputs arrive distributed
(``sharding.rules.distribute_tree``).  Every family runs so.  A mesh
without ranks executes nothing.  A stand-in whose ``shape`` is a dict
(``launch.mesh.abstract_mesh``) given to an untraced step builder raises.
A ``DeviceMesh`` over torch's fake group builds the step as the ranks run
it, but the step takes ``meta`` DTensors only (``require_distributed``):
its collectives dispatch and move nothing, which is how the dry-run counts
what one rank's step runs and dispatches (``roofline.trace.Lowered.count``).
A step built with ``trace=True`` (the dry-run's global trace) takes any
mesh but runs on plain ``meta`` tensors only: there a plain tensor passes
``constrain`` unchanged, and each call is recorded (``recording``).  A CPU
or CUDA tensor given to either still raises.

``carried`` runs a function under the context current when it was made,
in whatever thread calls it: a remat recompute runs in autograd's thread
(the card's device thread), where the context variables are unset.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from .. import is_dtensor, resolve_device
from .rules import (LogicalRules, NamedSharding, apply_rules, mesh_axes,
                    mesh_size)

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                      default=None)
_RECORD: contextvars.ContextVar = contextvars.ContextVar("shard_record",
                                                         default=None)


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[LogicalRules] = None):
    """``(mesh, rules)`` for ``constrain`` inside the block; a ``None`` mesh
    (an unmeshed step) leaves no context."""
    token = _CTX.set(None if mesh is None else (mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def recording():
    """Collect every ``constrain`` call inside the block, as dicts of
    ``names``, ``shape``, ``backward`` (made while autograd runs a
    backward: a remat recompute) and, for a DTensor, the ``placements``
    it was given; yields the list."""
    calls: list = []
    token = _RECORD.set(calls)
    try:
        yield calls
    finally:
        _RECORD.reset(token)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    calls = _RECORD.get()
    if calls is not None:
        calls.append({"names": tuple(names), "shape": tuple(x.shape),
                      "backward": torch._C._current_graph_task_id() != -1})
    mesh = ctx[0]
    if is_dtensor(x):
        y = x.redistribute(mesh, placements(names, x.shape, mesh))
        if calls is not None:
            calls[-1]["placements"] = tuple(map(repr, y.placements))
        return y
    if mesh_size(mesh) == 1 or x.device.type == "meta":
        return x
    raise TypeError(
        f"constrain: a plain tensor of shape {tuple(x.shape)} under a mesh "
        f"of {mesh_size(mesh)} devices {mesh_axes(mesh)}: a step's inputs "
        "arrive as DTensors (sharding.rules.distribute_tree), and so does "
        "everything computed from them")


def placements(names: Sequence[Optional[str]], shape, mesh) -> tuple:
    """The DTensor placements on ``mesh`` that ``constrain`` would give an
    array of ``shape`` with the logical axes ``names``: the active
    context's rules (``DEFAULT_RULES`` outside one)."""
    ctx = _CTX.get()
    rules = ctx[1] if ctx is not None else None
    return NamedSharding(mesh, apply_rules(names, shape, mesh, rules)
                         ).placements


def has_ranks(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` over a real process group (not a
    stand-in, an abstract mesh, or the fake group's)."""
    if not hasattr(mesh, "get_group"):
        return False
    import torch.distributed as dist
    return dist.get_backend(mesh.get_group(0)) != "fake"


def require_distributed(params) -> None:
    """Raise unless every param is a DTensor (a step across ranks), and,
    on a mesh without ranks (torch's fake group), a ``meta`` one."""
    from ..models.params import tree_leaves
    leaves = list(tree_leaves(params))
    plain = [".".join(p) for p, t in leaves if not is_dtensor(t)]
    if plain:
        raise TypeError(
            f"a step across ranks takes DTensor params; {plain[:3]} are "
            "plain: place them with sharding.distribute_tree(params, "
            "shardings_for(build_specs(cfg), mesh, rules))")
    if leaves and not has_ranks(leaves[0][1].device_mesh):
        held = [".".join(p) for p, t in leaves
                if t.to_local().device.type != "meta"]
        if held:
            raise NotImplementedError(
                f"a mesh without ranks (torch's fake group) executes "
                f"nothing: its steps take meta tensors, and {held[:3]} "
                "hold data")


def multi_rank(mesh) -> bool:
    """Whether a step on ``mesh`` runs across ranks (DTensor inputs)."""
    return mesh is not None and not isinstance(mesh, (str, torch.device)) \
        and mesh_size(mesh) > 1


def step_target(mesh, rules: Optional[LogicalRules] = None,
                trace: bool = False):
    """``(mesh or None, device)`` of a step builder's ``mesh`` argument: a
    device (a name, a ``torch.device``, or ``None`` for ``cuda``) gives the
    unmeshed step on it; a mesh, the meshed step on the mesh's device type.
    Rules without a mesh raise.  A mesh of more than one device must have
    ranks (``has_ranks``), or be a ``DeviceMesh`` over torch's fake group,
    whose step runs on ``meta`` DTensors (module docstring).  ``trace``
    gives a step traced on ``meta`` (on any mesh), whose inputs go through
    ``traced_input``."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        if rules is not None:
            raise ValueError("rules without a mesh: pass a mesh "
                             "(launch.mesh.make_local_mesh) with them")
        return None, resolve_device("meta" if trace else (mesh or "cuda"))
    if trace:
        return mesh, resolve_device("meta")
    n = mesh_size(mesh)
    if n != 1 and not has_ranks(mesh):
        if hasattr(mesh, "get_group"):          # torch's fake group
            return mesh, resolve_device("meta")
        raise NotImplementedError(
            f"a mesh of {n} devices {mesh_axes(mesh)} without ranks "
            f"({type(mesh).__name__}) executes nothing: build the step "
            "with trace=True, or pass a DeviceMesh over a real process "
            "group (launch.mesh.make_mesh) or over torch's fake group "
            "(meta tensors only)")
    return mesh, resolve_device(getattr(mesh, "device_type", None) or "cuda")


def traced_input(t):
    """A traced step's input as it is: a ``meta`` tensor, or ``None``.  A
    tensor with data raises: a traced step executes nothing."""
    if t is None or (isinstance(t, torch.Tensor) and t.device.type == "meta"):
        return t
    where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
    raise NotImplementedError(
        f"a traced step takes meta tensors, not {where}: it executes "
        "nothing; build the step without trace to run it")


def carried(fn):
    """``fn`` run under the sharding context and recording current now,
    wherever it is called from."""
    ctx, calls = _CTX.get(), _RECORD.get()

    def run(*args, **kwargs):
        tokens = _CTX.set(ctx), _RECORD.set(calls)
        try:
            return fn(*args, **kwargs)
        finally:
            _RECORD.reset(tokens[1])
            _CTX.reset(tokens[0])
    return run


def replicated_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (the same on every rank: a table of positions, RoPE's angles)
    as a replicated DTensor on ``like``'s mesh when ``like`` is a DTensor,
    else ``t`` as it is."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def whole(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor ``t`` with dimension ``dim`` gathered on every rank (its
    other shards kept), a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.ndim
    keep = tuple(Replicate() if isinstance(p, Shard) and p.dim % t.ndim == d
                 else p for p in t.placements)
    return t.redistribute(t.device_mesh, keep)


def sharded_as(t: torch.Tensor, dim: int, like) -> torch.Tensor:
    """A DTensor ``t`` with dimension ``dim`` split over the mesh
    dimensions that split the 1-d ``like`` (and over no other), its other
    placements kept: the operand of a product with ``like`` along that
    dimension (a per-head parameter).  Moving from replicated to split is
    a local slice; a plain tensor passes as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    d = dim % t.ndim
    keep = tuple(Shard(d) if isinstance(q, Shard)
                 else Replicate() if isinstance(p, Shard) and p.dim % t.ndim
                 == d else p
                 for p, q in zip(t.placements, like.placements))
    return t.redistribute(t.device_mesh, keep)


def traced_inputs(tree) -> None:
    """``traced_input`` on every leaf of nested dicts, lists and tuples
    (Python numbers pass: a decode state's ``pos``)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            traced_inputs(leaf)
    elif not isinstance(tree, (int, float)):
        traced_input(tree)
