"""Stand-ins for ``jax.stages.Lowered`` and ``Compiled``: a step traced on
``meta`` tensors (shapes and dtypes, no data, no device).

``Lowered`` holds a step's builder (``serve.serve_step``,
``train.train_step``), its ``meta`` arguments, their shardings on a mesh
and the donated arguments.  ``Lowered.compile()`` runs the step built with
``trace=True`` once on the ``meta`` tensors under a FLOP counter and a
dispatch mode that tallies every aten op, and returns a ``Compiled``:

* ``cost_analysis()``: ``{"flops", "bytes accessed"}`` per device.  FLOPs
  are ``torch.utils.flop_counter.FlopCounterMode``'s count of the products
  (matmuls, convolutions, attention), with a grouped ``convolution_backward``
  counted as twice its forward (``conv_backward_flop``: torch's formula
  ignores ``groups``).  Bytes are the unfused sum of every aten op's input
  and output bytes (views, which move nothing, and ``empty``, which writes
  nothing, excepted), which is what XLA's unfused count means.
* ``memory_analysis()``: ``argument_size_in_bytes``,
  ``output_size_in_bytes``, ``alias_size_in_bytes`` and
  ``temp_size_in_bytes`` per device.  Argument and output sizes sum each
  leaf's block (``NamedSharding.shard_shape``; an output with no sharding,
  or a Python int such as the decode state's ``pos``, counts whole, the int
  as an int32); a param that no op of the trace reads is left out, as
  ``jax.jit`` prunes unused arguments.  A donated argument leaf aliases the first output leaf of
  its shape, dtype and block, as XLA pairs ``donate_argnums`` buffers with
  outputs: the params and AdamW moments of a train step (updated in place
  here), the decode state of a serve step.  The temp size is the peak of
  the live storage the trace allocated, its outputs' storage left out.
* ``collectives()``: the collectives one rank's step dispatches
  (``Lowered.count_collectives``), per device.
* ``as_text()``: a readable account of the trace.

The trace is global: one process runs the whole step.  Per-device FLOPs,
bytes and temp are the global values divided by the chips that share the
work (every device of the mesh).  XLA's SPMD numbers count each device's
own program instead (work it repeats, such as heads too few to shard,
included), so on a production mesh the two differ.  A Python loop has no
``while`` body to undercount: the trace runs every layer.

The collectives are not global: they are what the reference reads from
XLA's per-device program, so ``count_collectives`` runs the step as one
rank runs it.  Each argument leaf becomes a ``meta`` DTensor of this
rank's block (its ``NamedSharding`` on the mesh), and the step built
without ``trace`` (DTensor params, ``constrain`` a real redistribution,
the kernels' ``kernels._local`` boundaries) runs once under
``sharding.collectives.CollectiveTally``: every collective dispatches and
moves nothing.  The mesh is the rank's own ``DeviceMesh`` where it is one,
else the abstract mesh's axes over torch's fake group
(``launch.mesh.rank_mesh``).  Calls and bytes come out under the
reference's names and byte convention (``CollectiveTally.by_kind``: each
call's result block on this rank, an all-reduce twice).
"""
from __future__ import annotations

import functools
import math
import time
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..models.params import tree_leaves, tree_unflatten
from ..sharding.rules import NamedSharding, P, mesh_size
from .analysis import CollectiveStats

aten = torch.ops.aten
# ops that allocate without writing: no bytes accessed
_NO_BYTES = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default}


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                       _padding, _dilation, transposed, _output_padding,
                       _groups, output_mask, out_shape=None, **_) -> int:
    """``aten.convolution_backward``'s FLOPs: each gradient asked for
    (input, weight) costs what the forward does, 2 FLOPs per output element
    per filter input (``w_shape[1:]``, which already holds ``C_in /
    groups``).  The forward's output is ``grad_out`` (a transposed
    convolution's: its input)."""
    out = grad_out_shape if not transposed else x_shape
    fwd = 2 * math.prod(out) * math.prod(w_shape[1:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """Bytes accessed by every aten op, calls by op, and each allocation and
    free of the storage allocated inside the mode, in order (storage that
    existed before, ``known``, is never counted)."""

    def __init__(self, known: Sequence[torch.Tensor] = ()):
        super().__init__()
        self.bytes = 0
        self.calls: Counter = Counter()
        self.op_bytes: Counter = Counter()
        self.read: set = set()          # storages some op took as input
        self.events: list = []          # (allocation number, +-bytes)
        self._seen = {id(t.untyped_storage()): None for t in known}

    def _free(self, key, serial, nbytes, _ref) -> None:
        self._seen.pop(key, None)
        self.events.append((serial, -nbytes))

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n, serial = st.nbytes(), len(self.events)
        self._seen[key] = (serial, weakref.ref(
            st, functools.partial(self._free, key, serial, n)))
        self.events.append((serial, n))

    def temp_bytes(self, outputs) -> int:
        """The peak of the live allocated bytes, the outputs' storage (still
        live at the end) left out, as XLA's temp size leaves them out."""
        out = set()
        for t in outputs:
            seen = self._seen.get(id(t.untyped_storage()))
            if seen is not None:
                out.add(seen[0])
        live = peak = 0
        for serial, n in self.events:
            if serial not in out:
                live += n
                peak = max(peak, live)
        return peak

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        self.calls[func] += 1
        ins = [t for t in _pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        in_ids = {id(t.untyped_storage()) for t in ins}
        # a view reads nothing; an aliasing op that copied (``to`` a new
        # dtype) did
        alias = func.is_view and all(id(t.untyped_storage()) in in_ids
                                     for t in outs)
        if not alias:
            self.read.update(in_ids)
        if not alias and func not in _NO_BYTES:
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += n
            self.op_bytes[func] += n
        for t in outs:
            self._track(t)
        return out


def _flatten(tree, sharding=None):
    """``(leaf, sharding)`` pairs of nested dicts (sorted keys), lists and
    tuples (NamedTuples too); ``sharding`` mirrors ``tree`` or is ``None``
    (the whole subtree unsharded)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k],
                                None if sharding is None else sharding[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, None if sharding is None else sharding[i])
    elif tree is not None:
        yield tree, sharding


def _leaf_shape(leaf):
    """(shape, dtype, itemsize) of a tensor, or of a Python int as an int32
    scalar (the decode state's ``pos``)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype, leaf.element_size()
    if isinstance(leaf, (bool, int)):
        return (), torch.int32, 4
    raise TypeError(f"no size for a leaf of type {type(leaf).__name__}")


def _block(leaf, sharding: Optional[NamedSharding]):
    shape, dtype, itemsize = _leaf_shape(leaf)
    block = shape if sharding is None else sharding.shard_shape(shape)
    return (shape, dtype, tuple(block)), math.prod(block) * itemsize


def _on_rank(tree, sharding, mesh):
    """``tree`` with each tensor leaf a ``meta`` DTensor of this rank's
    block on ``mesh``, placed as its ``NamedSharding`` (mirroring
    ``tree``; ``None``: the subtree replicated) places it on the lowered
    mesh; other leaves kept."""
    if isinstance(tree, dict):
        return {k: _on_rank(v, None if sharding is None else sharding[k],
                            mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_on_rank(v, None if sharding is None else sharding[i], mesh)
                 for i, v in enumerate(tree)]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    if not isinstance(tree, torch.Tensor):
        return tree
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    placements = NamedSharding(mesh, P() if sharding is None
                               else sharding.spec).placements
    block, _ = compute_local_shape_and_global_offset(tree.shape, mesh,
                                                     placements)
    local = torch.empty(block, dtype=tree.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


@dataclass
class Trace:
    """What one run of the step on ``meta`` tensors saw: global counts."""
    flops: float
    bytes: float
    temp_bytes: int                # peak live bytes, outputs left out
    outputs: Any                   # the step's return value
    unused: frozenset = frozenset()  # paths of the params no op read
    ops: Counter = field(default_factory=Counter)
    op_bytes: Counter = field(default_factory=Counter)
    op_flops: dict = field(default_factory=dict)
    seconds: float = 0.0


@dataclass
class MemoryAnalysis:
    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int


class Lowered:
    """A step and its ``meta`` inputs, as ``jax.jit(...).lower(...)``
    returns them.  ``build(mesh, trace)`` makes the step on a mesh, taking
    the arguments positionally (``trace=True``: the global trace's);
    ``kind`` is the shape's kind ("train", "prefill", "decode");
    ``params_argnum`` the argument that holds the params."""

    def __init__(self, build, args: tuple, in_shardings: tuple, *,
                 out_shardings=None, donate_argnums: tuple = (), mesh,
                 rules=None, kind: str, params_argnum: int = 0):
        self.build, self.fn = build, build(mesh, True)
        self.args = args
        self.in_shardings, self.out_shardings = in_shardings, out_shardings
        self.donate_argnums = tuple(donate_argnums)
        self.mesh, self.rules, self.kind = mesh, rules, kind
        self.params_argnum = params_argnum

    def count_collectives(self, params_dtype=None) -> CollectiveStats:
        """The collectives one rank's step dispatches on this mesh, by the
        reference's kind (module docstring); none on one device.
        ``params_dtype``: the params' floating type where the step's is not
        their specs' (bf16)."""
        if mesh_size(self.mesh) == 1:
            return CollectiveStats()
        from ..launch.mesh import rank_mesh
        from ..sharding.collectives import CollectiveTally
        args = list(self.args)
        if params_dtype is not None:
            args[self.params_argnum] = tree_unflatten(
                (path, t.to(params_dtype) if t.is_floating_point() else t)
                for path, t in tree_leaves(args[self.params_argnum]))
        with rank_mesh(self.mesh) as mesh:
            step = self.build(mesh, False)
            args = [_on_rank(a, s, mesh)
                    for a, s in zip(args, self.in_shardings)]
            with CollectiveTally() as tally:
                step(*args)
        counts, nbytes = tally.by_kind()
        return CollectiveStats(counts, nbytes)

    def trace(self) -> Trace:
        """Run the step once on its ``meta`` arguments."""
        known = [t for t, _ in _flatten(self.args)
                 if isinstance(t, torch.Tensor)]
        tally = _Tally(known)
        flops = FlopCounterMode(display=False, custom_mapping={
            aten.convolution_backward: conv_backward_flop})
        t0 = time.perf_counter()
        with flops, tally:
            out = self.fn(*self.args)
        by_op = flops.get_flop_counts().get("Global", {})
        unused = frozenset(
            path for path, t in tree_leaves(self.args[self.params_argnum])
            if id(t.untyped_storage()) not in tally.read)
        outs = [t for t, _ in _flatten(out) if isinstance(t, torch.Tensor)]
        return Trace(flops=float(flops.get_total_flops()),
                     bytes=float(tally.bytes),
                     temp_bytes=tally.temp_bytes(outs),
                     outputs=out,
                     unused=unused,
                     ops=tally.calls, op_bytes=tally.op_bytes,
                     op_flops=dict(by_op),
                     seconds=time.perf_counter() - t0)

    def compile(self, trace: Optional[Trace] = None) -> "Compiled":
        """The compiled stand-in; ``trace`` reuses an earlier run of the
        same step (its cost does not depend on the mesh)."""
        return Compiled(self, trace if trace is not None else self.trace())


class Compiled:
    """``jax.stages.Compiled``'s analyses of one traced step on a mesh."""

    def __init__(self, lowered: Lowered, trace: Trace):
        self.lowered, self.trace = lowered, trace
        self.chips = mesh_size(lowered.mesh)
        self._collectives: Optional[CollectiveStats] = None

    def cost_analysis(self) -> dict:
        return {"flops": self.trace.flops / self.chips,
                "bytes accessed": self.trace.bytes / self.chips}

    def memory_analysis(self) -> MemoryAnalysis:
        low = self.lowered
        args = [(_block(leaf, sh), i in low.donate_argnums)
                for i, (a, s) in enumerate(zip(low.args, low.in_shardings))
                for leaf, sh in _flatten(self._used(i, a), s)]
        outs = [_block(leaf, sh) for leaf, sh in
                _flatten(self.trace.outputs, low.out_shardings)]
        free = Counter(key for key, _ in outs)
        alias = 0
        for (key, nbytes), donated in args:
            if donated and free[key] > 0:
                free[key] -= 1
                alias += nbytes
        temp = self.trace.temp_bytes
        return MemoryAnalysis(
            argument_size_in_bytes=sum(n for (_, n), _ in args),
            output_size_in_bytes=sum(n for _, n in outs),
            alias_size_in_bytes=alias,
            temp_size_in_bytes=int(temp // self.chips))

    def _used(self, argnum: int, arg):
        """``arg`` without the params no op read (audio's ``embed`` under
        frame embeddings, a vlm's image K / V weights in a decode step),
        as ``jax.jit`` prunes unused arguments (``keep_unused=False``)."""
        if argnum != self.lowered.params_argnum or not self.trace.unused:
            return arg
        return {k: v for k, v in
                ((k, self._prune(v, (k,))) for k, v in arg.items())
                if v is not None}

    def _prune(self, tree, path):
        if not isinstance(tree, dict):
            return None if path in self.trace.unused else tree
        kept = {k: self._prune(v, path + (k,)) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None} or None

    def collectives(self) -> CollectiveStats:
        if self._collectives is None:
            self._collectives = self.lowered.count_collectives()
        return self._collectives

    def as_text(self, top: int = 12) -> str:
        """The trace in words: totals, the top ops by FLOPs and by bytes,
        and the collectives."""
        t = self.trace
        mem = self.memory_analysis()
        coll = self.collectives()
        lines = [
            f"traced {self.lowered.kind} step on {self.chips} device(s) in "
            f"{t.seconds:.2f} s: {sum(t.ops.values())} aten calls",
            f"global: {t.flops:.6g} FLOPs, {t.bytes:.6g} bytes accessed, "
            f"temp (peak live, outputs left out) {t.temp_bytes} bytes",
            f"per device: argument {mem.argument_size_in_bytes}, output "
            f"{mem.output_size_in_bytes}, alias {mem.alias_size_in_bytes}, "
            f"temp {mem.temp_size_in_bytes} bytes",
            "FLOPs by op:"]
        for op, n in sorted(t.op_flops.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"  {op}: {n:.6g}")
        lines.append("bytes by op (calls):")
        for op, n in t.op_bytes.most_common(top):
            lines.append(f"  {op}: {n:.6g} ({t.ops[op]})")
        lines.append("collectives per device:")
        for kind in sorted(coll.counts):
            lines.append(f"  {kind}: {coll.counts[kind]} calls, "
                         f"{coll.bytes_by_kind[kind]:.6g} bytes")
        return "\n".join(lines)
