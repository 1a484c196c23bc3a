"""The kernels' DTensor boundary.

The kernels run on plain tensors.  Given DTensor operands (a step on a mesh
of more than one rank), ``ops.rmsnorm``, ``ops.flash_attention``,
``ops.decode_attention`` and ``ops.ssd`` redistribute them to the placements
the kernel needs, run it on each rank's local shards (the CUDA kernel on the
card, the plain version on the CPU, by the local tensor's device) and wrap
its results as DTensors again, through
``torch.distributed.tensor.experimental.local_map`` with each gradient's
placements spelled out.  Only what the kernel needs whole is gathered: a row
for RMSNorm; the sequence and the head dimension for attention, whose batch
and heads stay sharded; the sequence for the SSD, whose batch and heads stay
sharded.  Mamba2's depthwise convolution (plain torch, no kernel) takes the
same road (``conv_on_shards``): DTensor's own convolution rule copies the
input's placements whatever the weight's.  So does the MoE layer's route,
dispatch, expert products and combine (``experts_on_shards``): DTensor has
no sharding strategy for ``searchsorted``, gathers ``argsort``'s operand,
and gives an ``index_select`` by a sharded index placements that are no
row gather; and a route must see the whole batch to drop the tokens one
device drops.  Decode attention over a cache whose sequence is split
(``seq_on_shards``) keeps the cache where it is and combines each rank's
partial attention over its own positions (flash-decoding's split-KV
reduction).  The loss (``vocab_on_shards``) keeps the logits where they
are too: each rank takes its own block of the vocab and the rows'
statistics are combined across ranks (Megatron's vocab-parallel
cross-entropy).

Gradients: a weight or KV head that every local shard reads sums its
gradient over those shards, so it leaves the local kernel as ``Partial()``
over each mesh dimension that splits them (RMSNorm's ``dw`` over the
sharded rows; K and V where the KV heads are replicated and each rank reads
its own group's; the SSD's B and C, which every head reads, over the
heads' mesh dimension; the convolution's weight over the batch's; the
experts' tokens and weights over the capacity's, and their tokens over
the ``ffn`` width's).  ``shard_calls()`` records each boundary call's
local operand shapes.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from .. import is_dtensor

_CALLS: Optional[list] = None


@contextlib.contextmanager
def shard_calls():
    """Inside: ``(name, local operand shapes)`` of every boundary call, in
    call order."""
    global _CALLS
    prev, _CALLS = _CALLS, []
    try:
        yield _CALLS
    finally:
        _CALLS = prev


def _note(name: str, *tensors) -> None:
    if _CALLS is not None:
        _CALLS.append((name, tuple(tuple(t.shape) for t in tensors)))


def _shard_dim(p, ndim: int) -> Optional[int]:
    """The array dimension a plain ``Shard`` placement splits, else None."""
    from torch.distributed.tensor import Shard
    return p.dim % ndim if type(p) is Shard else None


def _on_shards(name: str, fn: Callable, mesh, out_placements, operands,
               in_placements, grad_placements, args=(), pick=None):
    """``fn(*local operands, *args)`` through ``local_map``: each operand (a
    DTensor) redistributed to its ``in_placements``, its local shard made
    contiguous (the kernels take no strides) and its gradient given
    ``grad_placements``; ``pick`` edits the local operands first; the
    results wrapped on ``out_placements``, one placements tuple a result
    (``fn`` returns a tuple where there are several)."""
    from torch.distributed.tensor.experimental import local_map
    for t in operands:
        if not is_dtensor(t):
            raise TypeError(f"a plain {type(t).__name__} beside DTensor "
                            "operands: place every operand on the mesh")
    n = len(operands)

    def local(*xs):
        ops = [t.contiguous() for t in xs[:n]]
        if pick is not None:
            ops = pick(*ops)
        _note(name, *ops)
        return fn(*ops, *xs[n:])
    none = (None,) * len(args)
    return local_map(local, tuple(out_placements),
                     tuple(in_placements) + none,
                     tuple(grad_placements) + none, mesh,
                     redistribute_inputs=True)(*operands, *args)


def rows_on_shards(name: str, fn: Callable, x, weight, *args):
    """``fn(x, weight, *args)`` of a row-wise op over the last dimension
    (RMSNorm) on each rank's rows: x keeps every shard of a leading
    dimension and gathers the last; the weight is whole on every rank, and
    its gradient is partial over each mesh dimension that splits the
    rows."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    last = x.ndim - 1
    xp = tuple(p if _shard_dim(p, x.ndim) not in (None, last)
               else Replicate() for p in x.placements)
    wgrad = tuple(Replicate() if isinstance(p, Replicate) else Partial()
                  for p in xp)
    return _on_shards(name, fn, mesh, (xp,), (x, weight),
                      (xp, (Replicate(),) * mesh.ndim), (xp, wgrad), args)


def _kv_heads(H: int, KV: int, n: int, r: int):
    """The KV heads of rank ``r``'s ``H / n`` q heads (q head h reads KV head
    h // (H / KV)): a slice of whole groups, or of one head, where the local
    q heads make a GQA layout with them; else an index of one KV head per
    local q head (group 1)."""
    hl, g = H // n, H // KV
    heads = [(r * hl + i) // g for i in range(hl)]
    lo, nkv = heads[0], heads[-1] - heads[0] + 1
    if hl % nkv == 0 and heads == [lo + i // (hl // nkv) for i in range(hl)]:
        return slice(lo, lo + nkv)
    return torch.tensor(heads)


def _summed(t):
    """A DTensor with its pending sums (``Partial``) reduced, its other
    placements kept."""
    from torch.distributed.tensor import Replicate
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))


def heads_on_shards(name: str, fn: Callable, q, k, v):
    """``fn(q, k, v)`` of attention (q (B, Sq, H, hd), k / v (B, Skv, KV,
    hd)) on each rank's batch rows and heads: the batch keeps its shards
    (the same for q, k and v), the heads keep theirs on one mesh dimension
    whose size divides H, and everything else is gathered.  KV heads shard
    with the q heads where that mesh dimension divides KV as well (each
    rank then holds whole GQA groups); else K and V are whole on that
    dimension and each rank takes its own q heads' KV heads
    (``_kv_heads``), with their gradients partial over it.  A q that is
    a pending sum (a decode row's product by a weight split along its
    input) is summed first, and where it is then whole but K and V split
    their batch (a vlm's image K/V) it takes their batch split, a local
    slice: the keys stay where they are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    q = _summed(q)
    qp, kp, kg, pick = [], [], [], None    # q's, k / v's and their grads'
    for m, p in enumerate(q.placements):
        n, d = mesh.size(m), _shard_dim(p, q.ndim)
        if d is None and _shard_dim(k.placements[m], k.ndim) == 0:
            d = 0
        if d == 2 and (Shard(2) in qp or H % n):
            d = None                           # heads on one mesh dim only
        if d == 0 or (d == 2 and KV % n == 0):
            place = (Shard(d),) * 3
        elif d == 2:
            place = (Shard(2), Replicate(), Partial())
            pick = _kv_heads(H, KV, n, mesh.get_local_rank(m))
        else:
            place = (Replicate(),) * 3
        for placements, x in zip((qp, kp, kg), place):
            placements.append(x)

    def take(ql, kl, vl):
        sel = pick if isinstance(pick, slice) else pick.to(kl.device)
        return ql, kl[:, :, sel].contiguous(), vl[:, :, sel].contiguous()
    qp, kp = tuple(qp), tuple(kp)
    return _on_shards(name, fn, mesh, (qp,), (q, k, v), (qp, kp, kp),
                      (qp, tuple(kg), tuple(kg)),
                      pick=None if pick is None else take)


def seq_split(t) -> bool:
    """Whether a DTensor KV cache (B, S, KV, hd) has its sequence split on
    some mesh dimension."""
    return any(_shard_dim(p, t.ndim) == 1 for p in t.placements)


def seq_on_shards(name: str, fn: Callable, q, k, v, kv_len):
    """Decode attention of q (B, 1, H, hd) over a KV cache k / v (B, S,
    KV, hd) whose sequence is split across ranks, the cache left where it
    is.  ``fn(q, k, v, kv_len, offset) -> (o, m, l)`` is one block's step
    (``decode_attention_block``: the unnormalised f32 output, the rows' max
    and sum, positions masked by their global index from the block's first,
    ``offset``).  Per mesh dimension: one that splits the sequence gives
    each rank its own positions and q whole (one row); one that splits the
    cache's batch splits q's too; one that splits both q's heads and the
    cache's KV heads, and divides KV, keeps them split; any other is
    gathered (a q that is a pending sum is summed first).  Inside the
    local step the rows' maxima are all-reduced (max) over the sequence's
    mesh dimensions and each rank weighs its o and l by ``exp(m - max)``
    (0 for a rank with no valid position: its m is -inf); the ranks' sums
    of o and l (``Partial()``) give ``o / l``, cast to q's type once, its
    heads split again as q's were on those dimensions (a local slice)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = q.device_mesh
    KV = k.shape[2]
    q = _summed(q)
    qp, kp, op, seq_dims = [], [], [], []      # q's, the cache's, o / l's
    for m in range(mesh.ndim):
        kd = _shard_dim(k.placements[m], k.ndim)
        if kd == 1:
            place = (Replicate(), Shard(1), Partial())
            seq_dims.append(m)
        elif kd in (0, 2) and (kd == 0 or _shard_dim(
                q.placements[m], q.ndim) == 2 and KV % mesh.size(m) == 0):
            place = (Shard(kd),) * 3
        else:
            place = (Replicate(),) * 3
        for placements, x in zip((qp, kp, op), place):
            placements.append(x)
    qp, kp, op = map(tuple, (qp, kp, op))
    _, offset = compute_local_shape_and_global_offset(k.shape, mesh, kp)
    groups = [mesh.get_group(m) for m in seq_dims]

    def local(ql, kl, vl, n):
        o, mx, l = fn(ql, kl, vl, n, offset[1])
        top = mx.clone()
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        w = torch.exp(mx - top)[:, None, :, None]            # (B, 1, H, 1)
        return o * w, l[:, None, :, None] * w
    o, l = _on_shards(name, local, mesh, (op, op), (q, k, v), (qp, kp, kp),
                      (qp, kp, kp), (kv_len,))
    summed = tuple(Replicate() if m in seq_dims else p
                   for m, p in enumerate(op))
    out = o.redistribute(mesh, summed) / l.redistribute(mesh, summed)
    heads = tuple(q.placements[m] if m in seq_dims and _shard_dim(
        q.placements[m], q.ndim) is not None else p
                  for m, p in enumerate(summed))
    return out.to(q.dtype).redistribute(mesh, heads)


def vocab_on_shards(name: str, logits, labels, base: int = 0):
    """The rows' statistics of a cross-entropy over ``logits`` (..., V), a
    DTensor whose vocab may be split across ranks, the vocab never
    gathered (Megatron's vocab-parallel cross-entropy): ``(m, s, gold)``,
    each f32 of ``labels``' shape, m the rows' max, s the sum of exp(l -
    m) and gold the logit of column ``labels - base`` (0 where that column
    is none of the logits': a chunk's other labels).  Per mesh dimension:
    one that splits the vocab gives each rank its own columns; one that
    splits a leading dimension splits the labels' alike; any other is
    gathered.  Inside the local step each
    rank takes its columns' row max, all-reduced (max, no gradient) over
    the vocab's mesh dimensions, and its block's sum and gold logit (0 for
    a label outside the block), which leave it as ``Partial()`` over those
    dimensions and are summed.  The logits' gradient comes back on each
    rank's block, at the logits' placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = logits.device_mesh
    last = logits.ndim - 1
    lp, yp, sp, vocab_dims = [], [], [], []    # logits', labels', sums'
    for m, p in enumerate(logits.placements):
        d = _shard_dim(p, logits.ndim)
        if d == last:
            place = (Shard(last), Replicate(), Partial())
            vocab_dims.append(m)
        elif d is not None:
            place = (Shard(d),) * 3
        else:
            place = (Replicate(),) * 3
        for placements, q in zip((lp, yp, sp), place):
            placements.append(q)
    lp, yp, sp = map(tuple, (lp, yp, sp))
    mp = tuple(Replicate() if m in vocab_dims else p
               for m, p in enumerate(sp))
    _, offset = compute_local_shape_and_global_offset(logits.shape, mesh, lp)
    first = base + offset[-1]
    groups = [mesh.get_group(m) for m in vocab_dims]

    def local(lg, y):
        lg = lg.float()
        n = lg.shape[-1]
        top = lg.detach().amax(-1)
        for g in groups:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=g)
        s = torch.exp(lg - top[..., None]).sum(-1)
        col = y.long() - first
        gold = torch.gather(lg, -1, col.clamp(0, n - 1)[..., None])[..., 0]
        return top, s, torch.where((col >= 0) & (col < n), gold, 0.0)
    top, s, gold = _on_shards(name, local, mesh, (mp, sp, sp),
                              (logits, labels), (lp, yp), (lp, yp))
    return top, _summed(s), _summed(gold)


def _trailing(fn: Callable, t):
    """(the operands ``t`` adds, the local function): ``[t]`` and ``fn``
    where ``t`` is given, else none and ``fn`` with None as its last
    argument."""
    if t is not None:
        return [t], fn
    return [], lambda *xs: fn(*xs, None)


def ssd_on_shards(name: str, fn: Callable, x, a, B, C, initial_state=None):
    """``fn(x, a, B, C, initial_state) -> (y, final state)`` of the SSD (x
    (b, s, h, p), a (b, s, h), B / C (b, s, n): one group that every head
    reads; y like x, the states (b, h, p, n)) on each rank's batch rows and
    heads: x, a, y and the states keep x's batch shards and its head shards
    on one mesh dimension whose size divides h (else the heads are whole);
    the sequence, which the recurrence runs along, is gathered.  B and C
    keep the batch shards and are whole on the heads' mesh dimension, with
    their gradients partial over it.  ``initial_state`` may be None."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    h = x.shape[2]
    xp, ap, sp, bp, bg = [], [], [], [], []  # x / y, a, states, B / C, grads
    for m, p in enumerate(x.placements):
        d = _shard_dim(p, x.ndim)
        if d == 2 and (Shard(2) in xp or h % mesh.size(m)):
            d = None                           # heads on one mesh dim only
        if d == 0:
            place = (Shard(0),) * 5
        elif d == 2:
            place = (Shard(2), Shard(2), Shard(1), Replicate(), Partial())
        else:
            place = (Replicate(),) * 5
        for placements, q in zip((xp, ap, sp, bp, bg), place):
            placements.append(q)
    xp, ap, sp, bp, bg = map(tuple, (xp, ap, sp, bp, bg))
    extra, local = _trailing(fn, initial_state)
    return _on_shards(name, local, mesh, (xp, sp), [x, a, B, C] + extra,
                      [xp, ap, bp, bp] + [sp] * len(extra),
                      [xp, ap, bg, bg] + [sp] * len(extra))


def conv_on_shards(name: str, fn: Callable, x, w, state=None):
    """``fn(x, w, state) -> (out, new state)`` of a depthwise convolution
    along the sequence (x (b, s, ch), w (W, ch), the state (b, W - 1, ch)
    or None; out like x, the new state like the state) on each rank's batch
    rows and channels: each mesh dimension that splits w's channels splits
    x's, the state's and the results' the same way (the shards the rules
    give the conv weight and the decode state); one that splits the batch
    of x or of the state splits both (a decode state stays where it is),
    and w's gradient is partial over it.  The sequence is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    xp, wp, wg = [], [], []
    for m in range(mesh.ndim):
        if _shard_dim(w.placements[m], w.ndim) == 1:
            place = (Shard(2), Shard(1), Shard(1))
        elif any(_shard_dim(t.placements[m], t.ndim) == 0
                 for t in (x, state) if t is not None):
            place = (Shard(0), Replicate(), Partial())
        else:
            place = (Replicate(),) * 3
        for placements, q in zip((xp, wp, wg), place):
            placements.append(q)
    xp, wp, wg = map(tuple, (xp, wp, wg))
    extra, local = _trailing(fn, state)
    return _on_shards(name, local, mesh, (xp, xp), [x, w] + extra,
                      [xp, wp] + [xp] * len(extra),
                      [xp, wg] + [xp] * len(extra))


def experts_on_shards(gate: Callable, experts: Callable, h, router, w_gate,
                      w_up, w_down, C: int, eh_placements):
    """``(out (T, d), aux)`` of a top-k MoE layer on DTensors: h (T, d), the
    router (d, E), w_gate / w_up (E, d, f) and w_down (E, f, d), C rows an
    expert.  Two calls on local shards:

    * the route, global and the same on every rank: ``gate(h, router) ->
      (top_p, top_i, aux)`` on h's rows and the router's expert columns
      gathered, so every rank sorts and drops the whole batch's pairs as
      one device does; its results and both gradients are whole on every
      rank (the router's is sliced back to its shards by the step);
    * the experts: ``experts(h, top_p, top_i, w_gate, w_up, w_down, e0, c0,
      Cl)`` on this rank's experts ``[e0, e0 + El)`` (the mesh dimensions
      that split the weights' experts keep them split), its columns of the
      ``ffn`` width (a mesh dimension that splits w_gate's / w_up's ``ffn``
      dim 2 and w_down's dim 1, and not the experts, keeps that split: the
      rules give "model" to ``ffn`` where it cannot split the experts, as
      the reference's do; everything else of the weights, the FSDP axis,
      is gathered) and its capacity rows ``[c0, c0 + Cl)`` (the mesh
      dimensions where ``eh_placements``, the rules' placements of the (E,
      C, d) dispatch buffer, split the capacity and neither the experts
      nor ``ffn``).  Its ``out`` is ``Partial()`` over each mesh dimension
      that splits the experts, ``ffn`` or the capacity, as are the
      gradients of h and top_p; each weight's gradient is partial over a
      mesh dimension that splits the capacity and keeps its expert and
      ``ffn`` shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = h.device_mesh
    E, d = w_gate.shape[0], h.shape[1]
    whole = (Replicate(),) * mesh.ndim
    hr = h.redistribute(mesh, whole)           # one gather for both calls
    top_p, top_i, aux = _on_shards("moe_route", gate, mesh,
                                   (whole, whole, whole), (hr, router),
                                   (whole, whole), (whole, whole))
    # per mesh dimension: the buffer's, w_gate / w_up's and their grads',
    # w_down's and its grad's, out's
    split, wp, wg, dp, dg, outp = [], [], [], [], [], []
    for m in range(mesh.ndim):
        if _shard_dim(w_gate.placements[m], w_gate.ndim) == 0:
            place = (Shard(0),) * 5 + (Partial(),)
        elif (_shard_dim(w_gate.placements[m], w_gate.ndim) == 2
              and _shard_dim(w_down.placements[m], w_down.ndim) == 1):
            place = (Replicate(), Shard(2), Shard(2), Shard(1), Shard(1),
                     Partial())
        elif _shard_dim(eh_placements[m], 3) == 1:
            place = (Shard(1), Replicate(), Partial(), Replicate(),
                     Partial(), Partial())
        else:
            place = (Replicate(),) * 6
        for placements, q in zip((split, wp, wg, dp, dg, outp), place):
            placements.append(q)
    split, wp, wg, dp, dg, outp = map(tuple, (split, wp, wg, dp, dg, outp))
    (El, Cl, _), (e0, c0, _) = compute_local_shape_and_global_offset(
        (E, C, d), mesh, split)
    if _CALLS is not None:                     # the dispatch buffer's block
        _CALLS.append(("moe_buffer", ((El, Cl, d),)))
    out = _on_shards("moe_experts", experts, mesh, (outp,),
                     (hr, top_p, top_i, w_gate, w_up, w_down),
                     (whole, whole, whole, wp, wp, dp),
                     (outp, outp, whole, wg, wg, dg), args=(e0, c0, Cl))
    return out, aux
