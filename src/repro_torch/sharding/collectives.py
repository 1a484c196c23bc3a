"""Collectives of a step across ranks: host-staged replacements where the
transport needs them, and counts of what a step moved.

Ranks that share one card run over gloo (NCCL refuses two ranks on one
device).  gloo takes CUDA tensors in its c10d collectives (it copies them
through host memory itself), but the functional all-gather that DTensor's
redistribution calls (``_c10d_functional.all_gather_into_tensor``) crashes
a rank on CUDA tensors under gloo (torch 2.11, H100).  ``stage_through_host``
replaces it, for CUDA tensors only, with a host-staged all-gather: the shard
is copied to the host, gathered by gloo's CPU collective and copied back;
an all-gather has no arithmetic, so none of the step's arithmetic leaves
the card.  Each call is counted in ``STAGED`` (calls and bytes), which the
chip smoke prints beside the step's collectives.  (gloo's own collectives on
CUDA tensors pass through host memory too, and it sums an all-reduce or a
reduce-scatter there: the transport of ranks that share a card.)

``CollectiveTally`` counts the functional collectives a block dispatches
(DTensor issues every one of them) with torch's ``CommDebugMode``, and the
bytes of each call's result on this rank.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

# name -> {"calls": n, "bytes": b} of the host-staged collectives made
STAGED: Dict[str, Dict[str, int]] = {}
_LIBRARY = None


def _note(name: str, nbytes: int) -> None:
    entry = STAGED.setdefault(name, {"calls": 0, "bytes": 0})
    entry["calls"] += 1
    entry["bytes"] += nbytes


def _all_gather_staged(shard: torch.Tensor, group_size: int,
                       group_name: str) -> torch.Tensor:
    """``_c10d_functional.all_gather_into_tensor`` through the host: the
    ranks' shards stacked along dimension 0, on the shard's device."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise NotImplementedError(
            f"the host-staged all-gather serves gloo groups only, not "
            f"{backend}: do not call stage_through_host in a process that "
            "runs an NCCL group (ROADMAP item 5e)")
    host = shard.detach().contiguous().cpu()
    out = host.new_empty((group_size * host.shape[0],) + tuple(host.shape[1:]))
    dist.all_gather_into_tensor(out, host, group=group)
    _note("all_gather_into_tensor", out.numel() * out.element_size())
    return out.to(shard.device)


def stage_through_host() -> None:
    """Route the functional all-gather of CUDA tensors through the host
    (module docstring); once a process, before its first step.  It
    replaces the op's CUDA kernel for the whole process, so a group of
    another backend than gloo then raises on an all-gather."""
    global _LIBRARY
    if _LIBRARY is not None:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _all_gather_staged, "CUDA")
    _LIBRARY = lib


class CollectiveTally(CommDebugMode):
    """A ``CommDebugMode`` that also sums, by collective, the bytes of each
    call's result on this rank: ``get_comm_counts()`` as the mode gives
    them, ``comm_bytes`` a dict of the same names.  Dispatch modes are
    thread-local state that autograd carries into its threads, so a
    backward's collectives count too."""

    def __init__(self):
        super().__init__()
        self.comm_bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t is DTensor for t in types):
            return out          # DTensor desugars into what comes next
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.comm_registry:
            name = str(packet).rsplit(".", 1)[-1]
            results = out if isinstance(out, (list, tuple)) else [out]
            self.comm_bytes[name] = self.comm_bytes.get(name, 0) + sum(
                t.numel() * t.element_size() for t in results
                if isinstance(t, torch.Tensor))
        return out
