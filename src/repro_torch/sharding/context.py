"""Ambient activation-sharding context (torch).

Counterpart of ``repro.sharding.context``.  Model code calls
``constrain(x, ("batch", "seq", "act_embed"))``; when a (mesh, rules)
context is active (set by the train/serve step builders), a DTensor is
redistributed to the placements the rules give it, and a plain tensor
passes through unchanged as long as every mesh axis has size 1 (a one-device
mesh: the placements could only say "replicated").  Outside a context it is
a no-op (CPU tests, plain eager use).

A plain tensor under a mesh of more than one device raises, and so do the
step builders given such a mesh: executing a step across ranks (DTensor
params through every op and kernel boundary) is not part of the port yet.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from .. import resolve_device
from .rules import (LogicalRules, NamedSharding, apply_rules, mesh_axes,
                    mesh_size)

_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                      default=None)
_MULTI_RANK = ("executing a step across ranks is not ported (ROADMAP.md "
               "Queue 1, multi-rank execution)")


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[LogicalRules] = None):
    """``(mesh, rules)`` for ``constrain`` inside the block; a ``None`` mesh
    (an unmeshed step) leaves no context."""
    token = _CTX.set(None if mesh is None else (mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    ctx = _CTX.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        spec = apply_rules(names, x.shape, mesh, rules)
        return x.redistribute(mesh, NamedSharding(mesh, spec).placements)
    if mesh_size(mesh) == 1:
        return x
    raise NotImplementedError(
        f"constrain: a plain tensor of shape {tuple(x.shape)} under a mesh "
        f"of {mesh_size(mesh)} devices {mesh_axes(mesh)}; {_MULTI_RANK}")


def step_target(mesh, rules: Optional[LogicalRules] = None):
    """``(mesh or None, device)`` of a step builder's ``mesh`` argument: a
    device (a name, a ``torch.device``, or ``None`` for ``cuda``) gives the
    unmeshed step on it; a one-device mesh, the meshed step on the mesh's
    device type.  Rules without a mesh, and a mesh of more than one
    device, raise."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        if rules is not None:
            raise ValueError("rules without a mesh: pass a mesh "
                             "(launch.mesh.make_local_mesh) with them")
        return None, resolve_device(mesh or "cuda")
    n = mesh_size(mesh)
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices {mesh_axes(mesh)}: {_MULTI_RANK}; "
            "pass a one-device mesh (launch.mesh.make_local_mesh)")
    return mesh, resolve_device(getattr(mesh, "device_type", None) or "cuda")
