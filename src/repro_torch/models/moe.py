"""Top-k MoE FFN with sort-based dropping dispatch (torch).

Counterpart of ``repro.models.moe``, with the same parameter names, layouts
and arithmetic.  Tokens are routed to their top-k experts, sorted by expert
id, packed into a capacity-bounded (E, C, d) buffer (overflow dropped, as in
GShard), run through the expert SwiGLU as batched products, and added back
weighted by the renormalized router probabilities.  Also returns the
Switch-style load-balancing loss (E * f . P).

The ``ffn_norm`` RMSNorm goes through the port's kernel; the dispatch, the
expert products and the combine stay plain torch, as the JAX package has no
Pallas kernel for them.  The dispatch buffer and the expert outputs carry the
reference's ``constrain`` hints (experts over the model axis, the capacity
dim per the ``moe_capacity`` rule).  Across ranks (DTensor operands) the
layer runs through ``kernels._local.experts_on_shards``: the route is the
whole batch's on every rank (``gate``), and each rank runs ``experts`` on
its own experts and capacity rows, where the hints' placements decide
which rows are its own.

The combine gives the same bits on every run: each token's k rows are
gathered back and added in ascending expert id, the order in which the
reference's scatter over the expert-sorted list adds them, instead of an
``index_add_`` whose atomics on the card add in a varying order.  Across
ranks each rank adds its own experts' rows in that order (the others' are
zeros) and the ranks' partial sums are added by the reduction that follows
(over two ranks in either order: ``a + b`` and ``b + a`` round alike).
Every row
gather is an ``index_select`` by a permutation (or by the slots, whose only
repeated index is the discarded drop row): its backward is an
``index_add_`` that meets each row once, where advanced indexing's backward
(a sort-based ``index_put_``) took 37 % of granite's train step on the
card (PERF.md §5).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import is_dtensor
from ..kernels import rmsnorm
from ..kernels._local import experts_on_shards
from ..sharding.context import constrain, placements
from .config import ModelConfig
from .params import p


def moe_specs(cfg: ModelConfig, layers: int, prefix_axes=("layers",)):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    L, la = (layers,), prefix_axes
    return {
        "ffn_norm": p(L + (d,), la + ("norm",), init="ones"),
        "router": p(L + (d, E), la + ("embed_noshard", "experts")),
        "w_gate": p(L + (E, d, f), la + ("experts", "embed", "ffn")),
        "w_up": p(L + (E, d, f), la + ("experts", "embed", "ffn")),
        "w_down": p(L + (E, f, d), la + ("experts", "ffn", "embed")),
    }


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows per expert for ``T`` tokens (static).  Tiny token counts (decode
    steps) get drop-free capacity: dropping at serving time corrupts
    outputs."""
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * T * k / E))
    C = min(C, T)
    if T <= 4 * E:
        C = min(T, max(C, k))
        C = T if T <= E else C
    return C


def route(h: torch.Tensor, router: torch.Tensor, k: int):
    """Router of the tokens ``h`` (T, d): the product in the activations'
    type, then f32.  Returns (probs (T, E), renormalised top-k weights
    (T, k), expert ids (T, k))."""
    logits = (h @ router).float()                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_i


def gate(h: torch.Tensor, router: torch.Tensor, k: int):
    """The route of the tokens ``h`` (T, d) and its Switch-style
    load-balance loss E * f . P: (renormalised top-k weights (T, k), expert
    ids (T, k), aux f32 scalar)."""
    probs, top_p, top_i = route(h, router, k)
    T, E = probs.shape
    flat_e = top_i.reshape(-1)                            # (T*k,)
    dispatch_frac = torch.zeros(E, dtype=torch.float32, device=h.device)
    dispatch_frac.index_add_(
        0, flat_e, torch.full((T * k,), 1.0 / (T * k), device=h.device))
    importance = probs.mean(dim=0)
    return top_p, top_i, E * torch.sum(dispatch_frac * importance)


def experts(h, top_p, top_i, w_gate, w_up, w_down, e0: int = 0,
            c0: int = 0, Cl: Optional[int] = None, *, C: int, dtype,
            hint=constrain) -> torch.Tensor:
    """The dispatch, the expert SwiGLU and the combine of the routed tokens
    ``h`` (T, d) through the experts ``[e0, e0 + El)`` that ``w_gate`` /
    ``w_up`` (El, d, f) and ``w_down`` (El, f, d) hold, over the capacity
    rows ``[c0, c0 + Cl)`` of the ``C`` (all of them by default): out (T,
    d), the sum of each token's kept pairs among those experts and rows.
    The route (``top_p``, ``top_i``), and so the expert-sorted order, the
    positions and the drops, is the whole batch's.  ``hint`` constrains the
    dispatch buffer and the expert outputs (``constrain``; across ranks
    the boundary has placed them, and it is the identity)."""
    T, d = h.shape
    k = top_i.shape[1]
    El = w_gate.shape[0]
    Cl = C if Cl is None else Cl
    flat_e = top_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], top_p.reshape(-1)[order]
    # position within each expert's segment
    seg_start = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=h.device) - seg_start
    # kept (pos < C) and in this shard's experts and capacity rows
    keep = (pos < C) & (se >= e0) & (se < e0 + El) & (pos >= c0) \
        & (pos < c0 + Cl)
    slot = torch.where(keep, (se - e0) * Cl + pos - c0, El * Cl)  # drop row

    # h[order // k]: each (token, expert) pair's row, in expert order.  One
    # row per slot; every dropped entry writes zeros to the drop row.
    hs = h.unsqueeze(1).expand(T, k, d).reshape(T * k, d).index_select(
        0, order)
    buf = h.new_zeros((El * Cl + 1, d)).index_copy(
        0, slot, hs * keep[:, None].to(h.dtype))
    eh = hint(buf[:El * Cl].reshape(El, Cl, d),
              ("act_experts", "moe_capacity", None))

    g = F.silu(torch.bmm(eh, w_gate).float()).to(dtype)
    u = torch.bmm(eh, w_up)
    o = torch.bmm(g * u, w_down)                          # (El, Cl, d)
    o = hint(o, ("act_experts", "moe_capacity", None))

    flat_o = torch.cat([o.reshape(El * Cl, d), o.new_zeros((1, d))]
                       ).index_select(0, slot)
    weighted = flat_o * (sw * keep).to(dtype)[:, None]    # expert-sorted
    # Each token's k sorted positions, ascending: its experts in id order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=h.device)
    rows = weighted.index_select(
        0, inv.reshape(T, k).sort(dim=-1).values.reshape(-1)
    ).reshape(T, k, d)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def moe_ffn(x: torch.Tensor, lp, cfg: ModelConfig,
            force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar).  DTensor
    operands (a step across ranks) go through ``experts_on_shards``."""
    B, S, d = x.shape
    T = B * S
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps,
                force_ref=force_ref).reshape(T, d)
    C = capacity(cfg, T)
    body = functools.partial(experts, C=C, dtype=x.dtype)
    if is_dtensor(h):
        eh = placements(("act_experts", "moe_capacity", None),
                        (cfg.n_experts, C, d), h.device_mesh)
        out, aux = experts_on_shards(
            functools.partial(gate, k=cfg.top_k),
            functools.partial(body, hint=lambda t, names: t), h,
            lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"], C, eh)
    else:
        top_p, top_i, aux = gate(h, lp["router"], cfg.top_k)
        out = body(h, top_p, top_i, lp["w_gate"], lp["w_up"], lp["w_down"])
    return out.reshape(B, S, d), aux
