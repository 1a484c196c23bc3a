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
dim per the ``moe_capacity`` rule).

The combine gives the same bits on every run: each token's k rows are
gathered back and added in ascending expert id, the order in which the
reference's scatter over the expert-sorted list adds them, instead of an
``index_add_`` whose atomics on the card add in a varying order.  Every row
gather is an ``index_select`` by a permutation (or by the slots, whose only
repeated index is the discarded drop row): its backward is an
``index_add_`` that meets each row once, where advanced indexing's backward
(a sort-based ``index_put_``) took 37 % of granite's train step on the
card (PERF.md §5).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import rmsnorm
from ..sharding.context import constrain
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


def moe_ffn(x: torch.Tensor, lp, cfg: ModelConfig,
            force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps,
                force_ref=force_ref).reshape(T, d)

    probs, top_p, top_i = route(h, lp["router"], k)

    # Switch-style load-balance loss: E * f . P
    flat_e = top_i.reshape(-1)                            # (T*k,)
    dispatch_frac = torch.zeros(E, dtype=torch.float32, device=dev)
    dispatch_frac.index_add_(
        0, flat_e, torch.full((T * k,), 1.0 / (T * k), device=dev))
    importance = probs.mean(dim=0)
    aux = E * torch.sum(dispatch_frac * importance)

    C = capacity(cfg, T)
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], top_p.reshape(-1)[order]
    # position within each expert's segment
    seg_start = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=dev) - seg_start
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)         # E*C = drop row

    # h[order // k]: each (token, expert) pair's row, in expert order.  One
    # row per slot; every dropped entry writes zeros to the drop row.
    hs = h.unsqueeze(1).expand(T, k, d).reshape(T * k, d).index_select(
        0, order)
    buf = h.new_zeros((E * C + 1, d)).index_copy(
        0, slot, hs * keep[:, None].to(h.dtype))
    eh = constrain(buf[:E * C].reshape(E, C, d),
                   ("act_experts", "moe_capacity", None))

    g = F.silu(torch.bmm(eh, lp["w_gate"]).float()).to(x.dtype)
    u = torch.bmm(eh, lp["w_up"])
    o = torch.bmm(g * u, lp["w_down"])                    # (E, C, d)
    o = constrain(o, ("act_experts", "moe_capacity", None))

    flat_o = torch.cat([o.reshape(E * C, d), o.new_zeros((1, d))]
                       ).index_select(0, slot)
    weighted = flat_o * (sw * keep).to(x.dtype)[:, None]  # expert-sorted
    # Each token's k sorted positions, ascending: its experts in id order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    rows = weighted.index_select(
        0, inv.reshape(T, k).sort(dim=-1).values.reshape(-1)
    ).reshape(T, k, d)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out.reshape(B, S, d), aux
