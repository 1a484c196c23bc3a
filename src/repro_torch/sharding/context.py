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
A step built with ``trace=True`` (the dry-run's, ``roofline.trace``) takes
any mesh but runs on ``meta`` tensors only: there a plain tensor passes
``constrain`` unchanged, and each call is recorded (``recording``) for the
roofline's collective estimate.  A CPU or CUDA tensor given to such a step
still raises.
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
_RECORD: contextvars.ContextVar = contextvars.ContextVar("shard_record",
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


@contextlib.contextmanager
def recording():
    """Collect every ``constrain`` call inside the block, as dicts of
    ``names``, ``shape``, ``itemsize``, ``grad`` (the tensor requires grad)
    and ``backward`` (made while autograd runs a backward: a remat
    recompute); yields the list."""
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
                      "itemsize": x.element_size(),
                      "grad": x.requires_grad,
                      "backward": torch._C._current_graph_task_id() != -1})
    mesh, rules = ctx
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        spec = apply_rules(names, x.shape, mesh, rules)
        return x.redistribute(mesh, NamedSharding(mesh, spec).placements)
    if mesh_size(mesh) == 1 or x.device.type == "meta":
        return x
    raise NotImplementedError(
        f"constrain: a plain tensor of shape {tuple(x.shape)} under a mesh "
        f"of {mesh_size(mesh)} devices {mesh_axes(mesh)}; {_MULTI_RANK}")


def step_target(mesh, rules: Optional[LogicalRules] = None,
                trace: bool = False):
    """``(mesh or None, device)`` of a step builder's ``mesh`` argument: a
    device (a name, a ``torch.device``, or ``None`` for ``cuda``) gives the
    unmeshed step on it; a one-device mesh, the meshed step on the mesh's
    device type.  Rules without a mesh, and a mesh of more than one
    device, raise.  ``trace`` gives a step traced on ``meta`` (on any
    mesh), whose inputs go through ``traced_input``."""
    if mesh is None or isinstance(mesh, (str, torch.device)):
        if rules is not None:
            raise ValueError("rules without a mesh: pass a mesh "
                             "(launch.mesh.make_local_mesh) with them")
        return None, resolve_device("meta" if trace else (mesh or "cuda"))
    if trace:
        return mesh, resolve_device("meta")
    n = mesh_size(mesh)
    if n != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices {mesh_axes(mesh)}: {_MULTI_RANK}; "
            "pass a one-device mesh (launch.mesh.make_local_mesh)")
    return mesh, resolve_device(getattr(mesh, "device_type", None) or "cuda")


def traced_input(t):
    """A traced step's input as it is: a ``meta`` tensor, or ``None``.  A
    tensor with data raises: a traced step executes nothing, and executing
    on a mesh of more than one device is not ported."""
    if t is None or (isinstance(t, torch.Tensor) and t.device.type == "meta"):
        return t
    where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
    raise NotImplementedError(
        f"a traced step takes meta tensors, not {where}: it executes "
        f"nothing; {_MULTI_RANK}")


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
