"""Shared layer library: RoPE, attention block, SwiGLU MLP (torch).

Counterpart of ``repro.models.layers``, with the same parameter names and
arithmetic.  RMSNorm and prefill attention go through the port's kernels
(``..kernels``); ``force_ref=True`` runs their plain versions instead, for
on-card comparisons.  Products of two types (bf16 activations against f32
weights: audio's bf16 frame embeddings under f32 weights) promote the
narrower operand, as jnp does, where ``@`` in torch would raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import is_dtensor
from ..kernels import decode_attention, flash_attention, rmsnorm
from ..sharding.context import replicated_like
from .config import ModelConfig
from .params import p


def promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their promoted type (bf16 -> f32 is exact)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type, as ``jnp.matmul`` computes it."""
    a, b = promoted(a, b)
    return a @ b


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S).  Computed in f32.  On
    a DTensor x the angles (the same on every rank) are replicated."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    if angles.dim() == 2:
        angles = angles[None]                                # (1, S, hd/2)
    cos = replicated_like(torch.cos(angles)[:, :, None, :], x)
    sin = replicated_like(torch.sin(angles)[:, :, None, :], x)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- specs

def attention_specs(cfg: ModelConfig, layers: int, prefix_axes=("layers",)):
    """Stacked attention params for ``layers`` layers."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = (layers,)
    la = prefix_axes
    specs = {
        "attn_norm": p(L + (d,), la + ("norm",), init="ones"),
        "wq": p(L + (d, H * hd), la + ("embed", "heads")),
        "wk": p(L + (d, KV * hd), la + ("embed", "kv_heads")),
        "wv": p(L + (d, KV * hd), la + ("embed", "kv_heads")),
        "wo": p(L + (H * hd, d), la + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        specs["bq"] = p(L + (H * hd,), la + ("heads",), init="zeros")
        specs["bk"] = p(L + (KV * hd,), la + ("kv_heads",), init="zeros")
        specs["bv"] = p(L + (KV * hd,), la + ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = p(L + (hd,), la + ("norm",), init="ones")
        specs["k_norm"] = p(L + (hd,), la + ("norm",), init="ones")
    return specs


def mlp_specs(cfg: ModelConfig, layers: int, prefix_axes=("layers",)):
    d, f = cfg.d_model, cfg.d_ff
    L, la = (layers,), prefix_axes
    return {
        "ffn_norm": p(L + (d,), la + ("norm",), init="ones"),
        "w_gate": p(L + (d, f), la + ("embed", "ffn")),
        "w_up": p(L + (d, f), la + ("embed", "ffn")),
        "w_down": p(L + (f, d), la + ("ffn", "embed")),
    }


# ----------------------------------------------------------------- compute

def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  A DTensor table is read on each rank's rows of
    the vocabulary (its vocab shards kept, the embedding dimension
    gathered) for the tokens of its batch rows: a token outside the rank's
    rows reads zeros, so the result is partial over the vocab's mesh
    dimensions and their sum (the next ``constrain``) is exact.  The
    table's gradient is partial over the mesh dimensions that split the
    batch.  (DTensor's own sharding of the index fails its backward in
    torch 2.11: ``index_put``'s rule asserts on a ``Shard(-1)``.)"""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh

    def first_dim(p, ndim):        # a Shard of dimension 0
        return isinstance(p, Shard) and p.dim % ndim == 0
    tp = tuple(p if first_dim(p, table.ndim) else Replicate()
               for p in table.placements)
    kp = tuple(Replicate() if isinstance(t, Shard)
               or not first_dim(p, tokens.ndim) else p
               for t, p in zip(tp, tokens.placements))
    out = tuple(Partial() if isinstance(t, Shard) else k
                for t, k in zip(tp, kp))
    grad = tuple(Partial() if isinstance(k, Shard) else t
                 for t, k in zip(tp, kp))
    local = table.redistribute(mesh, tp).to_local(grad_placements=grad)
    toks = tokens.redistribute(mesh, kp).to_local()
    _, (lo, _) = compute_local_shape_and_global_offset(table.shape, mesh, tp)
    idx = toks.long() - lo
    hit = (idx >= 0) & (idx < local.shape[0])
    rows = local[idx.clamp(0, local.shape[0] - 1)]
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return DTensor.from_local(rows, mesh, out, run_check=False)


def split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(..., n * hd) -> (..., n, hd).  A DTensor whose flat head
    dimension is split by a mesh dimension that does not divide ``n`` (the
    rules shard ``n * hd`` columns, which may cut a head: 2 KV heads over 4
    ranks) is first gathered along that mesh dimension."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh, last = t.device_mesh, t.ndim - 1
        keep = tuple(Replicate() if isinstance(p, Shard)
                     and p.dim % t.ndim == last and n % mesh.size(m) else p
                     for m, p in enumerate(t.placements))
        if keep != tuple(t.placements):
            t = t.redistribute(mesh, keep)
    return t.reshape(*t.shape[:-1], n, hd)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., n, hd) -> (..., n * hd), ``split_heads``' inverse.  Where a
    mesh dimension does not divide ``n`` (24 heads over 16 ranks), a
    DTensor's gradient is brought back to the forward's placements first
    (an identity redistribution): the product that follows may hand back a
    gradient split along the flat columns, cutting a head, which DTensor
    cannot view as heads."""
    n, hd = t.shape[-2:]
    flat = t.reshape(*t.shape[:-2], n * hd)
    if is_dtensor(flat) and any(n % k for k in flat.device_mesh.shape):
        flat = flat.redistribute(flat.device_mesh, flat.placements)
    return flat


def write_cache(cache: torch.Tensor, start: int, new: torch.Tensor) -> None:
    """``cache[:, start:start + S] = new`` in the cache's type, in place.  A
    DTensor cache takes ``new`` at its own placements, but with the
    sequence whole where the cache's is split, and each rank writes its
    local shard: of a split sequence, only the positions of ``[start, start
    + S)`` that fall in its block, at their local offsets (a rank whose
    block holds none of them writes nothing)."""
    if is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        mesh = cache.device_mesh
        whole_seq = tuple(Replicate() if isinstance(p, Shard)
                          and p.dim % cache.ndim == 1 else p
                          for p in cache.placements)
        new = new.redistribute(mesh, whole_seq).to_local()
        (_, n, *_), (_, lo, *_) = compute_local_shape_and_global_offset(
            cache.shape, mesh, cache.placements)
        cache = cache.to_local()
        a, b = max(start, lo), min(start + new.shape[1], lo + n)
        if a < b:
            cache[:, a - lo:b - lo] = new[:, a - start:b - start].to(
                cache.dtype)
        return
    cache[:, start:start + new.shape[1]] = new.to(cache.dtype)


def write_state(state: torch.Tensor, new: torch.Tensor) -> None:
    """``state.copy_(new)``, in place: a DTensor state (one layer of a
    decode state's conv or SSD leaf) takes ``new`` at its own placements
    and each rank writes its local shard, as ``write_cache`` does."""
    if is_dtensor(state):
        new = new.redistribute(state.device_mesh, state.placements)
        state, new = state.to_local(), new.to_local()
    state.copy_(new)


def attention(x, lp, cfg: ModelConfig, *, positions, cache=None,
              cache_len=None, force_ref: bool = False):
    """Pre-norm attention sublayer.

    Prefill: ``cache is None`` -> causal flash attention.
    Decode: ``cache = (k_cache, v_cache)`` (B, S_max, KV, hd); the new k/v are
    written IN PLACE at position ``cache_len`` (an int), clamped to
    ``S_max - S`` as ``lax.dynamic_update_slice_in_dim`` clamps it, and
    attention runs over the first ``cache_len + S`` positions.
    Returns (residual output, cache_or_None).
    """
    S = x.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, force_ref=force_ref)
    q = matmul(h, lp["wq"])
    k = matmul(h, lp["wk"])
    v = matmul(h, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = split_heads(q, H, hd)
    k = split_heads(k, KV, hd)
    v = split_heads(v, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps, force_ref=force_ref)
        k = rmsnorm(k, lp["k_norm"], cfg.norm_eps, force_ref=force_ref)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        attn = flash_attention(q, k, v, causal=True, force_ref=force_ref)
    else:
        k_cache, v_cache = cache
        start = min(max(int(cache_len), 0), k_cache.shape[1] - S)
        write_cache(k_cache, start, k)
        write_cache(v_cache, start, v)
        attn = decode_attention(q, k_cache, v_cache, int(cache_len) + S)
    out = matmul(merge_heads(attn), lp["wo"])
    return out, cache


def swiglu(x, lp, cfg: ModelConfig, force_ref: bool = False):
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps, force_ref=force_ref)
    g = F.silu(matmul(h, lp["w_gate"]).float()).to(h.dtype)
    return matmul(g * matmul(h, lp["w_up"]), lp["w_down"])
