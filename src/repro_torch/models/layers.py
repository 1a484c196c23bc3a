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

from ..kernels import decode_attention, flash_attention, rmsnorm
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
    """x: (B, S, H, hd); positions: (S,) or (B, S).  Computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    if angles.dim() == 2:
        angles = angles[None]                                # (1, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
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
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps, force_ref=force_ref)
    q = matmul(h, lp["wq"])
    k = matmul(h, lp["wk"])
    v = matmul(h, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
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
        k_cache[:, start:start + S] = k.to(k_cache.dtype)
        v_cache[:, start:start + S] = v.to(v_cache.dtype)
        attn = decode_attention(q, k_cache, v_cache, int(cache_len) + S)
    out = matmul(attn.reshape(B, S, H * hd), lp["wo"])
    return out, cache


def swiglu(x, lp, cfg: ModelConfig, force_ref: bool = False):
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps, force_ref=force_ref)
    g = F.silu(matmul(h, lp["w_gate"]).float()).to(h.dtype)
    return matmul(g * matmul(h, lp["w_up"]), lp["w_down"])
