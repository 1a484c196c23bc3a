"""Stand-ins for ``jax.stages.Lowered`` and ``Compiled``: a step run on
``meta`` tensors (shapes and dtypes, no data, no device).

``Lowered`` holds a step's builder (``serve.serve_step``,
``train.train_step``), its ``meta`` arguments, their shardings on a mesh
and the donated arguments.  ``Lowered.compile()`` runs the step once under a
dispatch mode that tallies every aten op, and returns a ``Compiled``.  On a
mesh of one device that run is the global trace (``Lowered.trace``: the
step built with ``trace=True`` on plain ``meta`` tensors); on a mesh of
more than one it is one rank's own step (``Lowered.count``, below), so that
every per-device number is what that rank runs, as the reference's are
XLA's analyses of each device's own SPMD program:

* ``cost_analysis()``: ``{"flops", "bytes accessed"}`` per device.  FLOPs
  are ``torch.utils.flop_counter``'s count of the products (matmuls,
  convolutions, attention), with a grouped ``convolution_backward``
  counted as twice its forward (``conv_backward_flop``: torch's formula
  ignores ``groups``).  Bytes are the unfused sum of every aten op's input
  and output bytes (views, which move nothing, and ``empty``, which writes
  nothing, excepted), which is what XLA's unfused count means.
* ``memory_analysis()``: ``argument_size_in_bytes``,
  ``output_size_in_bytes``, ``alias_size_in_bytes`` and
  ``temp_size_in_bytes`` per device.  Argument and output sizes sum each
  leaf's block (``NamedSharding.shard_shape``; an output with no sharding,
  or a Python int such as the decode state's ``pos``, counts whole, the int
  as an int32); a param that no op of the run reads is left out, as
  ``jax.jit`` prunes unused arguments.  A donated argument leaf aliases the first output leaf of
  its shape, dtype and block, as XLA pairs ``donate_argnums`` buffers with
  outputs: the params and AdamW moments of a train step (updated in place
  here), the decode state of a serve step.  The temp size is the peak of
  the live storage the run allocated, its outputs' storage left out.
* ``collectives()``: the collectives the rank's step dispatches, per
  device (none on one device).
* ``as_text()``: a readable account of the run.

One rank's step (``Lowered.count``): each argument leaf becomes a ``meta``
DTensor of this rank's block (its ``NamedSharding`` on the mesh), and the
step built without ``trace`` (DTensor params, ``constrain`` a real
redistribution, the kernels' ``kernels._local`` boundaries) runs once under
``RankTally`` (over a ``sharding.collectives.CollectiveTally``): every
collective dispatches and moves nothing, and is counted under the
reference's names and byte convention (``CollectiveTally.by_kind``: each
call's result block on this rank, an all-reduce twice).  The same run
counts the FLOPs, bytes and allocations of the rank's local ops (the ops
on plain tensors that DTensor's dispatch runs on each rank's blocks), by
the global trace's rules; a collective's own tensors count no bytes (its
traffic is the roofline's collective term) but its result's allocation
counts toward the temp peak.  The mesh is the rank's own ``DeviceMesh`` where it is one,
else the abstract mesh's axes over torch's fake group
(``launch.mesh.rank_mesh``).  Work a rank repeats (the MoE route on the
whole batch, replicated weights read in full) is counted on every rank,
as XLA counts it in each device's program.  A Python loop has no ``while``
body to undercount: the step runs every layer; the dry-run
(``launch.dryrun``) counts two shallow depths and extrapolates
(``extrapolate_trace``).
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
_PLAIN = torch.Tensor.__torch_dispatch__     # what a subclass that adds none has
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
        self.made: dict = {}            # allocation number -> (op, shape)
        self.at_peak: list = []         # (bytes, op, shape) live at the peak
        self._seen = {id(t.untyped_storage()): None for t in known}

    def _free(self, key, serial, nbytes, _ref) -> None:
        self._seen.pop(key, None)
        self.events.append((serial, -nbytes))

    def _track(self, t: torch.Tensor, func) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n, serial = st.nbytes(), len(self.events)
        self._seen[key] = (serial, weakref.ref(
            st, functools.partial(self._free, key, serial, n)))
        self.events.append((serial, n))
        self.made[serial] = (str(func), tuple(t.shape))

    def temp_bytes(self, outputs, top: int = 8) -> int:
        """The peak of the live allocated bytes, the outputs' storage (still
        live at the end) left out, as XLA's temp size leaves them out;
        ``at_peak`` keeps the ``top`` largest allocations live then."""
        out = set()
        for t in outputs:
            seen = self._seen.get(id(t.untyped_storage()))
            if seen is not None:
                out.add(seen[0])
        total = peak = 0
        when = -1
        for i, (serial, n) in enumerate(self.events):
            if serial not in out:
                total += n
                if total > peak:
                    peak, when = total, i
        live = {}
        for serial, n in self.events[:when + 1]:
            if serial not in out:
                if n > 0:
                    live[serial] = n
                else:
                    live.pop(serial, None)
        self.at_peak = sorted(((n, *self.made[k]) for k, n in live.items()),
                              reverse=True)[:top]
        return peak

    def largest(self, top: int = 8) -> list:
        """The ``top`` largest allocations of the run, live at the peak or
        not: (bytes, op, shape), one an (op, shape)."""
        most: dict = {}
        for serial, n in self.events:
            if n > 0:
                key = self.made[serial]
                most[key] = max(n, most.get(key, 0))
        return sorted(((n, *k) for k, n in most.items()), reverse=True)[:top]

    def shapes(self) -> frozenset:
        """The shapes of every allocation of the run."""
        return frozenset(shape for _, shape in self.made.values())

    def count(self, func, args, kwargs, out, moves: bool = True) -> None:
        """Tally one op that ran: its call, the storage it read, its bytes
        (``moves``: a collective's tensors move no bytes here) and the
        storage it allocated."""
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
        if moves and not alias and func not in _NO_BYTES:
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.bytes += n
            self.op_bytes[func] += n
        for t in outs:
            self._track(t, func)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args, kwargs, out)
        return out


class RankTally(_Tally):
    """``_Tally`` of one rank's step on DTensors, FLOPs included: an op
    with an argument of a tensor subclass (a DTensor; the functional
    collectives' ``AsyncCollectiveTensor``) returns ``NotImplemented``, so
    that the subclass's dispatch runs and its local ops (the rank's own
    work, on plain tensors of its blocks) come back through the mode,
    which counts them.  FLOPs come from ``flop_registry``
    (``conv_backward_flop`` for ``convolution_backward``), as
    ``FlopCounterMode`` counts the global trace.  A collective
    (``sharding.collectives.COLLECTIVE_OPS``) moves no bytes here.
    Entering the mode enters a ``CollectiveTally`` below it, which then
    sees each local op and counts the collectives (``by_kind``): one run
    gives both.  ``known``: the storage that exists before the run (the
    arguments' blocks), which the temp peak leaves out.

    DTensor's sharding propagation is not counted: on a miss of its cache
    it runs each op on fake tensors of the global shapes (and traces
    decompositions on them) to learn the output's metadata, work no rank
    does, and a count that saw it would depend on the cache.  While the
    mode is entered, the propagator's two entry points
    (``propagate_op_sharding``, the cached one, and
    ``propagate_op_sharding_non_cached``, which the cached one, the C++
    dispatch's miss path and the decomposition tracer call) are wrapped to
    raise ``propagating``, and the mode passes every op through uncounted
    while it is raised.  That is exact: everything the propagator runs is
    metadata work, and none of the rank's local ops runs inside it (DTensor
    runs them after propagation returns)."""

    _ENTRIES = ("propagate_op_sharding", "propagate_op_sharding_non_cached")

    def __init__(self, known: Sequence[torch.Tensor] = ()):
        super().__init__(known)
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry, shape_wrapper
        from ..sharding.collectives import COLLECTIVE_OPS, CollectiveTally
        self._dtensor, self._collective = DTensor, COLLECTIVE_OPS
        self.comm = CollectiveTally()
        self._flop_registry = {**flop_registry, aten.convolution_backward:
                               shape_wrapper(conv_backward_flop)}
        self.flops = 0
        self.op_flops: Counter = Counter()
        self.propagating = 0
        self._saved: dict = {}

    def __enter__(self):
        prop = self._dtensor._op_dispatcher.sharding_propagator
        for name in self._ENTRIES:
            self._saved[name] = vars(prop).get(name)   # None: the class's
            setattr(prop, name, _Uncounted(getattr(prop, name), self))
        self.comm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.comm.__exit__(*exc)
        prop = self._dtensor._op_dispatcher.sharding_propagator
        for name, saved in self._saved.items():
            if saved is None:
                delattr(prop, name)
            else:
                setattr(prop, name, saved)
        self._saved.clear()

    def by_kind(self):
        """The collectives' (calls, bytes) by the reference's kind
        (``CollectiveTally.by_kind``)."""
        return self.comm.by_kind()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.propagating:
            return func(*args, **kwargs)
        if any(t.__torch_dispatch__ is not _PLAIN for t in types):
            return NotImplemented    # a DTensor, a collective's async result
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        packet = func._overloadpacket
        collective = packet in self._collective
        self.count(func, args, kwargs, out, moves=not collective)
        formula = self._flop_registry.get(packet)
        if formula is not None and not collective:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            self.op_flops[packet] += n
        return out


class _Uncounted:
    """A sharding-propagator entry point that raises ``tally.propagating``
    while it runs (``RankTally``); other attributes (``cache_clear``) are
    the wrapped one's."""

    def __init__(self, fn, tally: RankTally):
        self.fn, self.tally = fn, tally

    def __call__(self, *args, **kwargs):
        self.tally.propagating += 1
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.tally.propagating -= 1

    def __getattr__(self, name):
        return getattr(self.fn, name)


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


def _local(t):
    """A DTensor's block on this rank (its local tensor), else ``t``."""
    return getattr(t, "_local_tensor", t)


@dataclass
class Trace:
    """What one run of the step on ``meta`` tensors saw, per device: the
    global trace's counts on one device, one rank's on a mesh."""
    flops: float
    bytes: float
    temp_bytes: int                # peak live bytes, outputs left out
    outputs: Any                   # the step's return value
    unused: frozenset = frozenset()  # paths of the params no op read
    ops: Counter = field(default_factory=Counter)
    op_bytes: Counter = field(default_factory=Counter)
    op_flops: dict = field(default_factory=dict)
    seconds: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)
    at_peak: list = field(default_factory=list)  # (bytes, op, shape)
    largest: list = field(default_factory=list)  # of the run, ditto
    shapes: frozenset = frozenset()  # of every allocation


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

    def count(self, params_dtype=None) -> Trace:
        """One rank's own step on this mesh (module docstring), run once
        under ``RankTally``: its FLOPs, bytes, temp, outputs (DTensors),
        unused params and collectives.
        ``params_dtype``: the params' floating type where the step's is not
        their specs' (bf16)."""
        from ..launch.mesh import rank_mesh
        args = list(self.args)
        if params_dtype is not None:
            args[self.params_argnum] = tree_unflatten(
                (path, t.to(params_dtype) if t.is_floating_point() else t)
                for path, t in tree_leaves(args[self.params_argnum]))
        with rank_mesh(self.mesh) as mesh:
            step = self.build(mesh, False)
            args = [_on_rank(a, s, mesh)
                    for a, s in zip(args, self.in_shardings)]
            tally = RankTally([_local(t) for t, _ in _flatten(args)
                                if isinstance(t, torch.Tensor)])
            t0 = time.perf_counter()
            with tally:
                out = step(*args)
            seconds = time.perf_counter() - t0
        counts, nbytes = tally.by_kind()
        read = tally.read
        unused = frozenset(
            path for path, t in tree_leaves(args[self.params_argnum])
            if id(_local(t).untyped_storage()) not in read)
        outs = [_local(t) for t, _ in _flatten(out)
                if isinstance(t, torch.Tensor)]
        return Trace(flops=float(tally.flops), bytes=float(tally.bytes),
                     temp_bytes=tally.temp_bytes(outs), outputs=out,
                     unused=unused, ops=tally.calls,
                     op_bytes=tally.op_bytes, op_flops=dict(tally.op_flops),
                     seconds=seconds,
                     collectives=CollectiveStats(counts, nbytes),
                     at_peak=tally.at_peak, largest=tally.largest(),
                     shapes=tally.shapes())

    def trace(self) -> Trace:
        """Run the global step (built with ``trace=True``) once on its
        ``meta`` arguments."""
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
                     seconds=time.perf_counter() - t0,
                     at_peak=tally.at_peak, largest=tally.largest(),
                     shapes=tally.shapes())

    def compile(self, trace: Optional[Trace] = None) -> "Compiled":
        """The compiled stand-in: the global trace on one device, one
        rank's step (``count``) on a mesh of more than one; ``trace``
        stands in for that run (``extrapolate_trace``'s)."""
        if trace is None:
            trace = self.trace() if mesh_size(self.mesh) == 1 \
                else self.count()
        return Compiled(self, trace)


def _deepen(out1, out2, args1, args2, args):
    """The step's outputs at the depth of ``args`` from its outputs at two
    shallow depths (``out1`` / ``out2``, their arguments ``args1`` /
    ``args2``): a leaf of one shape at both depths keeps it; a leaf that
    grows with depth is an argument's new value (the params and moments of
    a train step, a decode state) and takes the shape of the argument that
    grew from the same shape to the same shape, so the outputs' blocks
    are exact at any depth (zamba2's ``ceil(L / 6)`` shared caches too)."""
    from torch.utils._pytree import tree_map
    grown = {}
    for (a1, _), (a2, _), (a, _) in zip(_flatten(args1), _flatten(args2),
                                        _flatten(args)):
        if isinstance(a, torch.Tensor) and a1.shape != a2.shape:
            grown.setdefault((tuple(a1.shape), tuple(a2.shape), a.dtype),
                             tuple(a.shape))

    def leaf(o1, o2):
        if not isinstance(o2, torch.Tensor) or o1.shape == o2.shape:
            return o2
        key = (tuple(o1.shape), tuple(o2.shape), o2.dtype)
        if key not in grown:
            raise ValueError(f"an output grows with depth ({key}) as no "
                             "argument does")
        return torch.empty(grown[key], dtype=o2.dtype, device="meta")
    return tree_map(leaf, out1, out2)


def extrapolate_trace(c1: "Compiled", c2: "Compiled", lowered: Lowered,
                      l1: int, l2: int, depth: int) -> Trace:
    """The run of ``lowered``'s step at ``depth`` layers from the same
    step compiled at ``l1`` and ``l2`` layers (``c1``, ``c2``; the
    dry-run's 2p and 3p), as the reference's ``run_cell`` extrapolates
    XLA's counts: FLOPs, bytes and temp linear in depth, clamped to be
    monotone in it; the collectives by ``analysis.extrapolate``, their
    total clamped the same way (where it would shrink, the shallow
    count's); the outputs by ``_deepen``; the unused params those unused
    at both depths.  Exact where each period past ``l1`` adds the same
    work (a train step's saved activations grow by one period's; a
    serving step's temp peak, one layer's working set, not at all).  A
    train step's temp peak is the larger of its backward's and a later
    part's (the update of a depth-stacked leaf), each linear in depth at
    its own rate: where the later one overtakes past ``l2``, the line
    through the two counts falls short, so temp is a lower bound."""
    from .analysis import extrapolate
    t1, t2 = c1.trace, c2.trace
    scale = (depth - l1) / max(1, l2 - l1)

    def linear(a, b):
        return max(a, a + (b - a) * scale)
    coll = extrapolate(t1.collectives, t2.collectives, l1, l2, depth)
    if coll.total_bytes < t1.collectives.total_bytes:
        coll = t1.collectives
    return Trace(
        flops=linear(t1.flops, t2.flops), bytes=linear(t1.bytes, t2.bytes),
        temp_bytes=int(linear(t1.temp_bytes, t2.temp_bytes)),
        outputs=_deepen(t1.outputs, t2.outputs, c1.lowered.args,
                        c2.lowered.args, lowered.args),
        unused=t1.unused & t2.unused, seconds=t1.seconds + t2.seconds,
        collectives=coll, at_peak=t2.at_peak, largest=t2.largest,
        shapes=t2.shapes)


class Compiled:
    """``jax.stages.Compiled``'s analyses of one counted step on a mesh."""

    def __init__(self, lowered: Lowered, trace: Trace):
        self.lowered, self.trace = lowered, trace
        self.chips = mesh_size(lowered.mesh)

    def cost_analysis(self) -> dict:
        return {"flops": self.trace.flops,
                "bytes accessed": self.trace.bytes}

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
        return MemoryAnalysis(
            argument_size_in_bytes=sum(n for (_, n), _ in args),
            output_size_in_bytes=sum(n for _, n in outs),
            alias_size_in_bytes=alias,
            temp_size_in_bytes=int(self.trace.temp_bytes))

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
        return self.trace.collectives

    def as_text(self, top: int = 12) -> str:
        """The run in words: totals, the top ops by FLOPs and by bytes,
        and the collectives."""
        t = self.trace
        mem = self.memory_analysis()
        coll = self.collectives()
        who = "global trace" if self.chips == 1 else "one rank's step"
        lines = [
            f"{self.lowered.kind} step on {self.chips} device(s), {who}, "
            f"run in {t.seconds:.2f} s: {sum(t.ops.values())} aten calls",
            f"per device: {t.flops:.6g} FLOPs, {t.bytes:.6g} bytes "
            f"accessed, argument {mem.argument_size_in_bytes}, output "
            f"{mem.output_size_in_bytes}, alias {mem.alias_size_in_bytes}, "
            f"temp (peak live, outputs left out) {mem.temp_size_in_bytes} "
            "bytes",
            "FLOPs by op:"]
        for op, n in sorted(t.op_flops.items(), key=lambda kv: -kv[1])[:top]:
            lines.append(f"  {op}: {n:.6g}")
        lines.append("bytes by op (calls):")
        for op, n in t.op_bytes.most_common(top):
            lines.append(f"  {op}: {n:.6g} ({t.ops[op]})")
        lines.append("largest allocations live at the temp peak:")
        for n, op, shape in t.at_peak:
            lines.append(f"  {op} {list(shape)}: {n} bytes")
        lines.append("largest allocations of the run:")
        for n, op, shape in t.largest:
            lines.append(f"  {op} {list(shape)}: {n} bytes")
        lines.append("collectives per device:")
        for kind in sorted(coll.counts):
            lines.append(f"  {kind}: {coll.counts[kind]} calls, "
                         f"{coll.bytes_by_kind[kind]:.6g} bytes")
        return "\n".join(lines)
