"""CUDA flash-attention forward (``csrc/flash_attention.cu``) bound to PyTorch.

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/kernel.py``), forward only.  On the H100 it is bound by
tensor FLOPs (4 * B * H * Sq * Skv * hd, about half under the causal mask,
over 989 TFLOP/s bf16).  Three variants, chosen by ``plan`` from the dtype
and head dim: ``wgmma`` (bf16, hd 64 / 128: TMA loads into an mbarrier ring,
warpgroup ``wgmma`` products, a producer and two consumer warpgroups),
``mma_sync`` (bf16, hd 16 / 32: warp-level ``mma.sync``) and ``fma`` (f32,
plain FMA, so nothing is rounded to bf16).  All skip the KV tiles the causal
mask removes — see the source.  ``plan`` holds all of the launch's host-side
arithmetic, and the C launcher takes its values as they are.
``flash_attention_cuda.launches`` counts launches, and
``flash_attention_cuda.variant_launches`` counts them by variant.
"""
from __future__ import annotations

import functools
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


@functools.cache
def _sm_count(device_index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(
        device_index or 0).multi_processor_count


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         softmax_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd)."""
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
    p = plan(q.dtype, hd, B, Sq, H, _sm_count(q.device.index))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if int(q_offset) < 0:
        raise ValueError(f"flash_attention_cuda: q_offset {q_offset} < 0")
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return o
    if Skv == 0:
        raise ValueError("flash_attention_cuda: empty key/value sequence")
    if not _build.aligned16(q, k, v, o):
        raise ValueError("flash_attention_cuda: tensors must be 16-byte "
                         "aligned")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Skv,
            H, KV, hd, _build.DTYPE_CODES[q.dtype], int(bool(causal)),
            int(q_offset), float(scale), VARIANTS[p.variant], p.block_q,
            p.block_kv, p.stages, *p.grid, p.smem_bytes, _build.stream_ptr(q))
    _build.check(lib, err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.variant_launches[p.variant] += 1
    return o


flash_attention_cuda.launches = 0
flash_attention_cuda.variant_launches = dict.fromkeys(VARIANTS, 0)
