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

``CollectiveTally`` counts the collectives a block dispatches (DTensor
issues the functional ones; decode attention over a split cache all-reduces
its rows' maxima with c10d's ``all_reduce``) with torch's
``CommDebugMode``, and the bytes of each call's result on this rank;
``by_kind()`` gives them under the names and the byte convention of the
reference's ``parse_collectives``.  On ``meta`` tensors the collectives
dispatch and move nothing (the dry-run's count, ``roofline.trace``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.debug._comm_mode import c10d_collective_ops
from torch.utils._pytree import tree_leaves

# name -> {"calls": n, "bytes": b} of the host-staged collectives made
STAGED: Dict[str, Dict[str, int]] = {}
_LIBRARY = None
# the reference's name (``repro.roofline.analysis.parse_collectives``) of
# each collective a rank dispatches
KINDS = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all",
         "all_reduce": "all-reduce",
         "allreduce_": "all-reduce"}
# the ops a rank's step communicates with (overload packets): what
# ``CommDebugMode`` counts, and the functional collectives' wait
COLLECTIVE_OPS = frozenset(
    CommDebugMode().comm_registry | set(c10d_collective_ops)
    | {torch.ops._c10d_functional.wait_tensor})


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
    """A ``CommDebugMode`` that also counts, by collective, the calls and
    the bytes of each call's result on this rank (an in-place c10d
    collective's result is its input): ``get_comm_counts()`` as the mode
    gives them, ``calls`` and ``comm_bytes`` dicts of the collectives'
    own names.  Dispatch modes are thread-local state that autograd
    carries into its threads, so a backward's collectives count too."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = {}
        self.comm_bytes: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t is DTensor for t in types):
            return out          # DTensor desugars into what comes next
        packet = getattr(func, "_overloadpacket", None)
        c10d = packet in c10d_collective_ops
        if c10d or packet in self.comm_registry:
            name = str(packet).rsplit(".", 1)[-1]
            result = args[0] if c10d else out
            self.calls[name] = self.calls.get(name, 0) + 1
            self.comm_bytes[name] = self.comm_bytes.get(name, 0) + sum(
                t.numel() * t.element_size() for t in tree_leaves(result)
                if isinstance(t, torch.Tensor))
        return out

    def by_kind(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(calls, bytes) by the reference's kind (``KINDS``), an
        all-reduce's bytes twice its result's, as ``parse_collectives``
        folds in a ring's two phases.  A collective without a kind
        raises."""
        other = sorted(set(self.calls) - set(KINDS))
        if other:
            raise KeyError(f"collectives without a kind in KINDS: {other}")
        counts: Dict[str, int] = {}
        nbytes: Dict[str, int] = {}
        for name, n in self.calls.items():
            kind = KINDS[name]
            factor = 2 if kind == "all-reduce" else 1
            counts[kind] = counts.get(kind, 0) + n
            nbytes[kind] = (nbytes.get(kind, 0)
                            + factor * self.comm_bytes[name])
        return counts, nbytes
