"""Mesh construction (torch): ``DeviceMesh``es with the reference's axis names.

Counterpart of ``repro.launch.mesh``.  FUNCTIONS (not module-level
constants), so importing this module never touches ``torch.distributed``.

A ``DeviceMesh`` needs a default process group, even for one device.
``make_local_mesh`` starts a one-rank group (over an in-process
``HashStore``: no port, no other process) only when none exists, and
``release_local_mesh(mesh)`` destroys that group if the call that returned
``mesh`` started it.  A process that forks after a mesh (the process
driver's shard workers) should release it first, so that no child inherits
a live group.

``make_production_mesh`` builds the (16, 16) or (2, 16, 16) mesh over
torch's fake process group (one process stands in for every rank, and
collectives do nothing), the counterpart of the reference's forced host
devices: enough to place and shard tensors, not to compute across ranks.
A process has one default group, so one that built a local mesh cannot then
build a production mesh (and the reverse): run such code in its own process.

``make_mesh(shape, axes)`` is the counterpart of ``jax.make_mesh`` on real
devices: a ``DeviceMesh`` over the default process group that the caller
started, one rank a device of the mesh.  Its backend is the group's, read
and never chosen here: gloo for ranks on the CPU and for ranks that share
one card (NCCL refuses two ranks on one device), NCCL for ranks on cards of
their own.

``abstract_mesh`` is a mesh's axis names and sizes alone (no device, no
group): what the dry-run (``launch.dryrun``) lowers on, any number of them
in one process.  To count one rank's step
(``roofline.trace.Lowered.count``) an abstract mesh becomes a
``DeviceMesh`` of its axes over ranks [0, n) of torch's fake group
(``rank_mesh``): one group of ``FAKE_WORLD`` ranks holds both production
meshes, (2, 16, 16) and (16, 16) over ranks 0-255.  It is started only
when the process has no default group, and destroyed when the block that
started it ends (``fake_ranks``), so that a process which counts can build
a local mesh afterwards.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Tuple

from .. import resolve_device

LOCAL_AXES = ("data", "model")
FAKE_WORLD = 512         # ranks of the fake group the dry-run counts on
_STARTED = None          # the local mesh whose call started the group


def _have_group(kind: str):
    """Whether a default group exists; raises if it is not one a ``kind``
    mesh can use."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return False
    backend = dist.get_backend()
    if (kind == "production") != (backend == "fake"):
        raise RuntimeError(
            f"this process already has a {backend!r} default process group "
            f"(world size {dist.get_world_size()}); a {kind} mesh needs "
            f"{'the fake' if kind == 'production' else 'a real'} one: build "
            "it in a process of its own")
    return True


def make_local_mesh(device="cuda"):
    """1-device mesh (same axis names, all size 1) on ``device``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    global _STARTED
    dev = resolve_device(device)
    started = not _have_group("local")
    if started:
        backend = ("nccl" if dev.type == "cuda" and dist.is_nccl_available()
                   else "gloo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"make_local_mesh: the default group has "
                           f"{dist.get_world_size()} ranks, not 1")
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=LOCAL_AXES)
    if started:
        _STARTED = mesh
    return mesh


def release_local_mesh(mesh) -> bool:
    """Destroy the default group if ``make_local_mesh`` started it when it
    returned ``mesh`` (every mesh on the group becomes unusable); a group
    that was there before is left alone.  Returns whether it destroyed
    one."""
    import torch.distributed as dist
    global _STARTED
    if mesh is None or mesh is not _STARTED:
        return False
    _STARTED = None
    if not dist.is_initialized():
        return False
    dist.destroy_process_group()
    return True


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` (the reference's:
    ("data", "model") or ("pod", "data", "model")) over the default group,
    whose world size must be the product of ``shape``; rank r holds the
    row-major r-th device of the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} vs axes {axes}")
    if not _have_group("local"):
        raise RuntimeError("make_mesh: no default process group; start one "
                           "(torch.distributed.init_process_group) on every "
                           "rank first")
    world = 1
    for n in shape:
        world *= n
    if dist.get_world_size() != world:
        raise RuntimeError(f"make_mesh: the default group has "
                           f"{dist.get_world_size()} ranks; a {tuple(shape)} "
                           f"mesh needs {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, on CPU ranks of the fake process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = 1
    for n in shape:
        world *= n
    if not _have_group("production"):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if dist.get_world_size() != world:
        raise RuntimeError(
            f"the fake group has {dist.get_world_size()} ranks; a {shape} "
            f"mesh needs {world}: build it in a process of its own")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh as the rules read it: ``shape`` is the dict of axis name ->
    size (as a JAX mesh's is); its tensors are ``meta`` ones."""
    axes: Tuple[Tuple[str, int], ...]
    device_type: str = "meta"

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)


def abstract_mesh(*, multi_pod: bool = False, local: bool = False
                  ) -> AbstractMesh:
    """The production mesh's axes ((16, 16), or (2, 16, 16) with
    ``multi_pod``), or the local mesh's (1, 1), without devices."""
    if local:
        return AbstractMesh(tuple(zip(LOCAL_AXES, (1, 1))))
    if multi_pod:
        return AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
    return AbstractMesh((("data", 16), ("model", 16)))


@contextlib.contextmanager
def fake_ranks():
    """Torch's fake process group of ``FAKE_WORLD`` ranks (this process is
    rank 0; collectives move nothing) for the block: started only when the
    process has no default group, and destroyed on leaving if this call
    started it.  A fake group already there serves as it is; a real one
    raises.  Destroying it also empties DTensor's cache of sharding
    decisions: a cached decision holds the mesh it was made on, whose
    groups are gone, and a later mesh of the same layout equals it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    started = not _have_group("production")
    if started:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    try:
        yield
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
            _forget_meshes()


def _forget_meshes() -> None:
    """Empty DTensor's caches that hold a mesh (its sharding decisions, in
    Python and in its C++ dispatch path, and its redistribution plans)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    DTensor._op_dispatcher.sharding_propagator \
        .propagate_op_sharding.cache_clear()
    for clear in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(_redistribute, "clear_redistribute_planner_cache",
                          None)):
        if clear is not None:
            clear()


@contextlib.contextmanager
def rank_mesh(mesh):
    """The ``DeviceMesh`` that one rank's step on ``mesh`` runs on, as rank
    0: ``mesh`` itself where it is one (a rank of a real group counts on
    its own mesh), else a mesh of its axes over ranks [0, n) of the fake
    group, inside ``fake_ranks``.  That mesh's device type is "cuda", as
    an H100 rank's is, whether or not a card is there (its tensors are
    ``meta``): DTensor picks some routes by the mesh's device type (a
    shard moved to another dimension is an all-to-all on "cuda", an
    all-gather and a local chunk on "cpu", gloo's fallback)."""
    if hasattr(mesh, "get_group"):
        yield mesh
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from ..sharding.rules import mesh_axes
    names, sizes = zip(*mesh_axes(mesh).items())
    n = math.prod(sizes)
    with fake_ranks():
        if dist.get_world_size() < n:
            raise RuntimeError(
                f"the fake group has {dist.get_world_size()} ranks; a "
                f"{sizes} mesh needs {n}: count in a process of its own")
        yield DeviceMesh("cuda", torch.arange(n).reshape(sizes),
                         mesh_dim_names=names)
