"""CUDA flash-attention forward and backward (``csrc/flash_attention.cu``)
bound to PyTorch.

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/kernel.py``); the JAX package has no backward kernel, and
``flash_attention_bwd_cuda`` computes what ``jax.grad`` of its reference
computes.  On the H100 it is bound by
tensor FLOPs (4 * B * H * Sq * Skv * hd, about half under the causal mask,
over 989 TFLOP/s bf16).  Three variants, chosen by ``plan`` from the dtype
and head dim: ``wgmma`` (bf16, hd 64 / 128: TMA loads into an mbarrier ring,
warpgroup ``wgmma`` products, a producer and two consumer warpgroups),
``mma_sync`` (bf16, hd 16 / 32: warp-level ``mma.sync``) and ``fma`` (f32,
plain FMA, so nothing is rounded to bf16).  All skip the KV tiles the causal
mask removes — see the source.  ``plan`` holds all of the launch's host-side
arithmetic, and the C launcher takes its values as they are.
``flash_attention_cuda.launches`` counts launches, and
``flash_attention_cuda.variant_launches`` counts them by variant.  With
``return_lse`` the forward also writes each row's log-sum-exp, the
backward's input (serving passes none, so its launches are unchanged).

The backward (FlashAttention-2's, bound by tensor FLOPs: 2.5x the
forward's) takes one CTA per (64-key block, KV head, b), loops over the
group's q heads and the q blocks the mask keeps, accumulates dK and dV on
chip and adds dQ with f32 atomics: ``mma_sync`` for bf16, ``fma`` for f32
(``bwd_plan``).  ``flash_attention_bwd_cuda.launches`` counts its calls.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _build

HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = {"wgmma": 0, "mma_sync": 1, "fma": 2}  # csrc/flash_attention.cu Variant
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)


@dataclass(frozen=True)
class FlashPlan:
    """How one launch is laid out: the kernel variant, q rows per CTA, KV
    rows per tile, ring slots, threads per CTA, the grid and the dynamic
    shared memory in bytes."""
    variant: str
    block_q: int
    block_kv: int
    stages: int
    threads: int
    grid: tuple
    smem_bytes: int


def plan(dtype: torch.dtype, hd: int, B: int, Sq: int, H: int,
         sms: int = 132) -> FlashPlan:
    """The launch plan for q (B, Sq, H, hd) of ``dtype`` on a card with
    ``sms`` SMs; the sizes mirror the structs of csrc/flash_attention.cu
    (``WgSmem``, ``MmaSmem``, ``Smem``), whose launcher refuses a plan
    smaller than its kernel needs."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and hd >= 64:
        # Two Q tiles, then `stages` K tiles and `stages` V tiles of 128
        # keys; the barriers (q_full, q_empty per Q tile; k_full, v_full,
        # empty per slot); 1024 bytes to align the tiles to the 128-byte
        # swizzle's period.  hd 64 takes four slots (161 KB), hd 128 two
        # (193 KB): one CTA an SM, as the persistent grid assumes.
        block_q, block_kv, stages = 128, 128, (4 if hd == 64 else 2)
        smem = ((2 * block_q + 2 * stages * block_kv) * hd * 2
                + (4 + 3 * stages) * 8 + 1024)
        items = -(-Sq // block_q) * H * B
        return FlashPlan("wgmma", block_q, block_kv, stages, 384,
                         (min(sms, items), 1, 1), smem)
    grid = (-(-Sq // 64), H, B)
    if dtype == torch.bfloat16:
        # Q, K and V tiles of 64 rows, rows padded by 8 bf16.
        return FlashPlan("mma_sync", 64, 64, 1, 128, grid, 3 * 64 * (hd + 8) * 2)
    if dtype == torch.float32:
        # Q^T (hd x 68), K (64 x hd+1), V (64 x hd), P^T (64 x 68), f32.
        floats = hd * 68 + 64 * (hd + 1) + 64 * hd + 64 * 68
        return FlashPlan("fma", 64, 64, 1, 256, grid, 4 * floats)
    raise TypeError(f"flash attention: no kernel for {dtype}")


BWD_BLOCK_KV = 64                # keys per backward CTA


def bwd_plan(dtype: torch.dtype, hd: int, B: int, Skv: int,
             KV: int) -> FlashPlan:
    """The backward's launch plan; sizes mirror ``BwdMmaSmem`` and
    ``BwdFmaSmem`` in csrc/flash_attention.cu, whose launcher refuses a plan
    smaller than its kernel needs."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in {HEAD_DIMS}")
    grid = (-(-Skv // BWD_BLOCK_KV), KV, B)
    if dtype == torch.bfloat16:
        # K, V (64 rows), Q, dO (block_q rows), padded by 8 bf16; dS
        # (block_q x 72 bf16); lse and D (block_q f32).  32 q rows at hd 128
        # keep both score tiles and the dK / dV accumulators in registers.
        block_q = 32 if hd == 128 else 64
        elems = (2 * BWD_BLOCK_KV + 2 * block_q) * (hd + 8) + block_q * 72
        return FlashPlan("mma_sync", block_q, BWD_BLOCK_KV, 1, 128, grid,
                         2 * elems + 8 * block_q)
    if dtype == torch.float32:
        # K, V, Q, dO (64 rows of hd + 1), P / dS (64 x 65), lse and D.
        floats = 4 * 64 * (hd + 1) + 64 * 65 + 2 * 64
        return FlashPlan("fma", 64, BWD_BLOCK_KV, 1, 256, grid, 4 * floats)
    raise TypeError(f"flash attention: no kernel for {dtype}")


def kv_tiles(q0: int, block_q: int, block_kv: int, Sq: int, Skv: int,
             causal: bool, q_offset: int) -> tuple:
    """(KV tiles loaded, first tile that needs the mask) for the q tile whose
    first row is ``q0``.  Tiles wholly above the causal diagonal are not
    loaded; a tile needs the mask when it holds a key past the tile's
    smallest q position or at or past Skv.  The kernels compute the same."""
    q_last = min(q0 + block_q, Sq) - 1
    kv_end = min(Skv, q_offset + q_last + 1) if causal else Skv
    n_tiles = -(-kv_end // block_kv)
    first = (q_offset + q0 + 1) // block_kv if causal else n_tiles
    return n_tiles, min(first, Skv // block_kv)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         softmax_scale: Optional[float] = None,
                         return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd), and
    with ``return_lse`` also the rows' log-sum-exp (B, H, Sq) f32."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA "
                         f"device (got {q.device}, {k.device}, {v.device})")
    if q.dtype not in _build.DTYPE_CODES or not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention_cuda: q, k, v must all be float32 or "
                        f"bfloat16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)} (need H % KV == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    p = plan(q.dtype, hd, B, Sq, H, _build.sm_count(q.device.index))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention_cuda: q_offset {q_offset} < 0")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B == 0 or Sq == 0:
        return (o, lse) if return_lse else o
    if Skv == 0:
        raise ValueError("flash_attention_cuda: empty key/value sequence")
    if not _build.aligned16(q, k, v, o):
        raise ValueError("flash_attention_cuda: tensors must be 16-byte "
                         "aligned")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if return_lse else None, B, Sq, Skv, H, KV, hd, _build.DTYPE_CODES[q.dtype], int(bool(causal)),
            int(q_offset), float(scale), VARIANTS[p.variant], p.block_q,
            p.block_kv, p.stages, *p.grid, p.smem_bytes, _build.stream_ptr(q))
    _build.check(lib, err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[p.variant] += 1
    return (o, lse) if return_lse else o


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             q_offset: int = 0,
                             softmax_scale: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention_cuda`` at ``do``, from its output
    ``o`` and ``lse`` (``return_lse=True``); each like its input."""
    ts = (q, k, v, o, lse, do)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_attention_bwd_cuda: q, k, v, o, lse, do must "
                         "be on one CUDA device (got "
                         f"{[str(t.device) for t in ts]})")
    if (q.dtype not in _build.DTYPE_CODES
            or not q.dtype == k.dtype == v.dtype == o.dtype == do.dtype
            or lse.dtype != torch.float32):
        raise TypeError("flash_attention_bwd_cuda: q, k, v, o, do must share "
                        "float32 or bfloat16 and lse be float32 (got "
                        f"{[t.dtype for t in ts]})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_bwd_cuda: bad shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if (Bk != B or hdk != hd or KV == 0 or H % KV or o.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, H, Sq)):
        raise ValueError("flash_attention_bwd_cuda: shapes do not match: q "
                         f"{tuple(q.shape)} k/v {tuple(k.shape)} o "
                         f"{tuple(o.shape)} do {tuple(do.shape)} lse "
                         f"{tuple(lse.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention_bwd_cuda: inputs must be contiguous")
    if int(q_offset) < 0 or Skv == 0:
        raise ValueError("flash_attention_bwd_cuda: q_offset < 0 or empty "
                         "key/value sequence")
    p = bwd_plan(q.dtype, hd, B, Skv, KV)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return dq_acc.to(q.dtype), dk.zero_(), dv.zero_()
    if not _build.aligned16(q, k, v, o, do, dk, dv):
        raise ValueError("flash_attention_bwd_cuda: tensors must be 16-byte "
                         "aligned")
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq_acc.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KV, hd,
            _build.DTYPE_CODES[q.dtype], int(bool(causal)), int(q_offset),
            float(scale), VARIANTS[p.variant], p.block_q, p.threads, *p.grid,
            p.smem_bytes, _build.stream_ptr(q))
    _build.check(lib, err, "flash_attn_bwd")
    flash_attention_bwd_cuda.launches += 1
    dq = dq_acc if q.dtype == torch.float32 else dq_acc.to(q.dtype)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
