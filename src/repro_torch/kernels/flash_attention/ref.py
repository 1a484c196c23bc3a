"""Plain PyTorch blockwise (flash) attention with GQA, and decode attention.

Same arithmetic as ``repro.kernels.flash_attention.ref``: an exact online
softmax over KV blocks (f32 m/l/acc), KV padded to a block multiple and masked
by the valid length, ``q_offset`` for chunked prefill.  It is the CPU path and
the reference the CUDA kernel is held against; ``flash_attention_bwd_ref`` is
its gradient, written out (the reference to the CUDA backward).
``decode_attention_ref`` stays plain torch on every device: the JAX package
has no kernel for it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        block_kv: int = 1024,
                        softmax_scale: Optional[float] = None,
                        return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.

    Returns (B, Sq, H, hd) in q.dtype; accumulation in f32.  With
    ``return_lse`` also each row's log-sum-exp of the scaled, masked scores,
    (B, H, Sq) f32 — what the CUDA forward writes for the backward.
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {KV}")
    groups = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)

    block_kv = min(block_kv, Skv)
    kv_valid = Skv
    if Skv % block_kv:  # pad KV to a block multiple (masked out)
        pad = block_kv - Skv % block_kv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        Skv += pad
    nb = Skv // block_kv

    qf = (q.float() * scale).permute(0, 2, 1, 3)            # (B, H, Sq, hd)
    qg = qf.reshape(B, KV, groups, Sq, hd)
    kb = k.float().reshape(B, nb, block_kv, KV, hd)
    vb = v.float().reshape(B, nb, block_kv, KV, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    o = torch.zeros((B, KV, groups, Sq, hd), dtype=torch.float32,
                    device=q.device)
    m = torch.full((B, KV, groups, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, groups, Sq), dtype=torch.float32, device=q.device)
    for j in range(nb):
        kblk, vblk = kb[:, j], vb[:, j]                    # (B, bk, KV, hd)
        s = torch.einsum("bkgqd,bckd->bkgqc", qg, kblk)
        k_pos = j * block_kv + torch.arange(block_kv, device=q.device)
        mask = (k_pos[None, :] < kv_valid).expand(Sq, block_kv)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bkgqc,bckd->bkgqd", p, vblk)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    o = o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(torch.clamp(l, min=1e-30))).reshape(B, H, Sq)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            q_offset: int = 0,
                            scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of ``flash_attention_ref`` at ``do``, from its
    output ``o`` and row log-sum-exp ``lse`` (B, H, Sq), with explicit
    formulas in f32: D = rowsum(dO * O), P = exp(scale Q K^T - lse) (masked),
    dV = P^T dO, dS = P (dO V^T - D), dQ = scale dS K, dK = scale dS^T Q;
    dK and dV summed over each GQA group of H / KV heads.  Each gradient in
    its input's dtype."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    groups = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    def heads(t):                                  # (B, S, n, hd) -> (B, n, S, hd)
        return t.float().permute(0, 2, 1, 3)
    qf = heads(q).reshape(B, KV, groups, Sq, hd)
    of = heads(o).reshape(B, KV, groups, Sq, hd)
    dof = heads(do).reshape(B, KV, groups, Sq, hd)
    kf, vf = heads(k), heads(v)                    # (B, KV, Skv, hd)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf) * scale
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = (q_pos[:, None] >= k_pos[None, :]) if causal else torch.ones(
        Sq, Skv, dtype=torch.bool, device=q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, groups, Sq, 1)),
                    0.0)
    D = (dof * of).sum(-1, keepdim=True)
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p, dof)
    ds = p * (torch.einsum("bkgqd,bkcd->bkgqc", dof, vf) - D)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qf) * scale

    def back(t, dtype):                            # (B, n, S, hd) -> (B, S, n, hd)
        return t.permute(0, 2, 1, 3).to(dtype)
    return (back(dq.reshape(B, H, Sq, hd), q.dtype), back(dk, k.dtype),
            back(dv, v.dtype))


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len, softmax_scale: Optional[float] = None):
    """Single-token decode attention over a (possibly padded) KV cache.

    q: (B, 1, H, hd); k, v: (B, S_max, KV, hd); ``kv_len`` = valid prefix
    length (int, 0-d tensor or (B,) tensor; an int costs no host-to-device
    copy).
    """
    B, _, H, hd = q.shape
    _, S, KV, _ = k.shape
    groups = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qg = (q.float() * scale).reshape(B, KV, groups, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    pos = torch.arange(S, device=q.device)
    if isinstance(kv_len, torch.Tensor):
        kv_len = kv_len.to(q.device).reshape(-1, 1)
    valid = (pos[None, :] < kv_len).expand(-1, S)           # (1 or B, S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)
