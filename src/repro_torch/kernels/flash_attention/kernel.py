"""CUDA flash-attention forward and backward (``csrc/flash_attention.cu``)
bound to PyTorch.

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/kernel.py``); the JAX package has no backward kernel, and
``flash_attention_bwd_cuda`` computes what ``jax.grad`` of its reference
computes.  On the H100 it is bound by
tensor FLOPs (4 * B * H * Sq * Skv * hd, about half under the causal mask,
over 989 TFLOP/s bf16), and at one query row by the bytes of K and V.  Four
variants, chosen by ``plan`` from the dtype, the head dim and Sq: ``wgmma``
(bf16, hd 64 / 128, Sq >= 2: TMA loads into an mbarrier ring, warpgroup
``wgmma`` products, a producer and two consumer warpgroups), ``decode``
(bf16, hd 64 / 128, Sq = 1: decode's cross-attention; one CTA per (key
split, KV head, b) with the GQA group's heads as its rows on ``mma.sync``,
K and V read once, the splits of a group one thread-block cluster that
merges their partials through distributed shared memory), ``mma_sync``
(bf16, hd 16 / 32: warp-level ``mma.sync``) and ``fma`` (f32, plain FMA,
so nothing is rounded to bf16).  All skip the KV tiles the causal mask
removes — see the source.  ``plan`` holds all of the launch's host-side
arithmetic, and the C launcher takes its values as they are.
``flash_attention_cuda.launches`` counts launches, and
``flash_attention_cuda.variant_launches`` counts them by variant.  With
``return_lse`` the forward also writes each row's log-sum-exp, the
backward's input (serving passes none, so its launches are unchanged).

The backward (bound by tensor FLOPs: 2.5x the forward's) loops, for each
key block and KV head, over the group's q heads and the q blocks the mask
keeps, accumulates dK and dV on chip and adds dQ into an f32 buffer that its
D pass zeroes.  ``bwd_plan`` picks ``wgmma`` for bf16 hd 64 / 128
(FlashAttention-3's backward in outline: a persistent grid over 128-key
items, a producer warpgroup TMA-loading Q and dO through an mbarrier ring,
two consumer warpgroups on ``wgmma``, dQ by a TMA reduce-add of each 64 x 64
tile; ``bwd_items`` mirrors its schedule), ``mma_sync`` for bf16 hd 16 / 32
and ``fma`` for f32.  ``flash_attention_bwd_cuda.launches`` counts its
calls, and ``flash_attention_bwd_cuda.variant_launches`` counts them by
variant.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .. import _build

HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = {"wgmma": 0, "mma_sync": 1, "fma": 2,
            "decode": 3}         # csrc/flash_attention.cu Variant
SMEM_LIMIT = 232448              # dynamic shared memory a block may use (H100)
DECODE_ROWS = 16                 # decode: q heads a row tile (mma.sync's M)
DECODE_CHUNK = 16                # decode: a split's keys come in chunks of 16
DECODE_SPLITS = 16               # decode: splits (CTAs of a cluster) at most
DECODE_FILL = 2                  # decode: CTAs an SM the grid aims at, at most


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
         sms: int = 132, *, Skv: Optional[int] = None,
         KV: Optional[int] = None, causal: bool = False, q_offset: int = 0,
         variant: Optional[str] = None) -> FlashPlan:
    """The launch plan for q (B, Sq, H, hd) of ``dtype`` over k, v (B, Skv,
    KV, hd) on a card with ``sms`` SMs; the sizes mirror the structs of
    csrc/flash_attention.cu (``WgSmem``, ``DecSmem``, ``MmaSmem``,
    ``Smem``), whose launcher refuses a plan smaller than its kernel needs.
    The variant follows from the dtype, hd and Sq; ``variant="wgmma"`` asks
    for the ``wgmma`` one at Sq = 1 too (to time it beside ``decode``).
    ``decode`` needs Skv and KV (its splits), and ``causal`` / ``q_offset``
    (the keys the mask keeps)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in {HEAD_DIMS}")
    tensor_core = dtype == torch.bfloat16 and hd >= 64
    if variant is None and tensor_core:
        variant = "decode" if Sq == 1 else "wgmma"
    elif variant is not None and not (tensor_core
                                      and variant in ("wgmma", "decode")):
        raise ValueError(f"flash attention: no {variant} variant for {dtype}"
                         f" at hd {hd}")
    if variant == "decode":
        if Sq != 1 or Skv is None or KV is None:
            raise ValueError("flash attention: the decode variant takes Sq = "
                             f"1 (got {Sq}) and needs Skv and KV")
        return decode_plan(hd, B, H, Skv, KV, causal, q_offset, sms)
    if variant == "wgmma":
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


def decode_keys(Skv: int, causal: bool, q_offset: int) -> int:
    """Keys the one query row at ``q_offset`` sees: all Skv, or under the
    causal mask those up to its own position."""
    return min(Skv, q_offset + 1) if causal else Skv


def decode_plan(hd: int, B: int, H: int, Skv: int, KV: int, causal: bool,
                q_offset: int, sms: int = 132) -> FlashPlan:
    """The ``decode`` variant's plan: one CTA of 4 warps per (key split, KV
    head x row tile, b), ``grid = (splits, KV * row tiles, b)``; a row tile
    is up to ``DECODE_ROWS`` heads of one GQA group, and the splits of one
    (KV head, row tile, b) are one cluster.  The splits: the largest power
    of two up to ``DECODE_SPLITS`` that keeps the grid within
    ``DECODE_FILL`` CTAs an SM (so that every cluster is resident at once)
    and no split empty, cut at 16-key chunks as evenly as they go
    (``decode_splits``).  ``block_kv`` is the chunk.  Shared memory
    (``DecSmem``): each warp's two ring slots of 16 K and 16 V rows (padded
    by 8 bf16), which the merge reuses for the warps' f32 partial o and the
    split's, then the warps' and the split's m and l."""
    if KV <= 0 or H % KV:
        raise ValueError(f"flash attention: H {H} not a multiple of KV {KV}")
    tiles = -(-(H // KV) // DECODE_ROWS)
    pairs = B * KV * tiles
    chunks = -(-decode_keys(Skv, causal, q_offset) // DECODE_CHUNK)
    splits = DECODE_SPLITS
    while splits > 1 and (pairs * splits > DECODE_FILL * sms
                          or splits > chunks):
        splits //= 2
    warps, stages = 4, 2
    ring = warps * stages * 2 * DECODE_CHUNK * (hd + 8) * 2
    accs = warps * DECODE_ROWS * (hd + 8) * 4 + DECODE_ROWS * hd * 4
    smem = max(ring, accs) + 2 * warps * DECODE_ROWS * 4 + 2 * DECODE_ROWS * 4
    return FlashPlan("decode", DECODE_ROWS, DECODE_CHUNK, stages, 32 * warps,
                     (splits, KV * tiles, B), smem)


def decode_splits(p: FlashPlan, Skv: int, causal: bool,
                  q_offset: int) -> list:
    """The [begin, end) keys of each split of a ``decode`` plan, as the
    kernel cuts them (``dec_split_begin``): split i of n starts at chunk
    i * chunks // n."""
    n_keys = decode_keys(Skv, causal, q_offset)
    chunks, n = -(-n_keys // p.block_kv), p.grid[0]
    return [(i * chunks // n * p.block_kv,
             min((i + 1) * chunks // n * p.block_kv, n_keys))
            for i in range(n)]


BWD_BLOCK_KV = 64                # keys per CTA of the mma_sync and fma backwards
BWD_WG_BLOCK_KV = 128            # keys per work item of the wgmma backward
BWD_WG_BLOCK_Q = 64              # q rows per ring slot of the wgmma backward


def bwd_plan(dtype: torch.dtype, hd: int, B: int, Skv: int,
             KV: int, sms: int = 132) -> FlashPlan:
    """The backward's launch plan on a card with ``sms`` SMs; sizes mirror
    ``BwdWgSmem``, ``BwdMmaSmem`` and ``BwdFmaSmem`` in
    csrc/flash_attention.cu, whose launcher refuses a plan smaller than its
    kernel needs."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16 and hd >= 64:
        # K and V tiles of 128 keys (two of each at hd 64, so the next
        # item's load overlaps this one); `stages` ring slots of Q and dO
        # (64 rows each); two dS buffers and one P buffer (64 x 128 bf16
        # each), at hd 128 a second P buffer (P's rounding remainder); each
        # consumer's f32 dQ tile (64 x 64); lse and D (64 f32 a slot); the
        # barriers (full and empty a slot, kv_full and kv_empty a K / V
        # buffer); 1024 bytes to align the tiles to the 128-byte swizzle's
        # period.  hd 64 takes four slots (216 KB), hd 128 two (231 KB):
        # one CTA an SM, as the persistent grid assumes.
        block_kv, block_q = BWD_WG_BLOCK_KV, BWD_WG_BLOCK_Q
        stages, kv_bufs = (4, 2) if hd == 64 else (2, 1)
        smem = (2 * kv_bufs * block_kv * hd * 2 + 2 * stages * block_q * hd * 2
                + (4 if hd == 128 else 3) * block_q * block_kv * 2
                + 2 * block_q * 64 * 4
                + 2 * stages * block_q * 4 + (2 * stages + 2 * kv_bufs) * 8
                + 1024)
        items = -(-Skv // block_kv) * KV * B
        return FlashPlan("wgmma", block_q, block_kv, stages, 384,
                         (min(sms, items), 1, 1), smem)
    grid = (-(-Skv // BWD_BLOCK_KV), KV, B)
    if dtype == torch.bfloat16:
        # K, V (64 rows), Q, dO (64 rows), padded by 8 bf16; dS (64 x 72
        # bf16); lse and D (64 f32).
        block_q = 64
        elems = (2 * BWD_BLOCK_KV + 2 * block_q) * (hd + 8) + block_q * 72
        return FlashPlan("mma_sync", block_q, BWD_BLOCK_KV, 1, 128, grid,
                         2 * elems + 8 * block_q)
    if dtype == torch.float32:
        # K, V, Q, dO (64 rows of hd + 1), P / dS (64 x 65), lse and D.
        floats = 4 * 64 * (hd + 1) + 64 * 65 + 2 * 64
        return FlashPlan("fma", 64, BWD_BLOCK_KV, 1, 256, grid, 4 * floats)
    raise TypeError(f"flash attention: no kernel for {dtype}")


def bwd_items(p: FlashPlan, B: int, Skv: int, KV: int) -> list:
    """The (k0, kvh, b) work items each CTA of a persistent ``wgmma``
    backward grid takes, in its order, as ``bwd_item`` and the kernel's
    item decoding in csrc/flash_attention.cu walk them: round r gives CTA i
    item r G + i for even r and r G + G - 1 - i for odd r (G CTAs)."""
    n_items = -(-Skv // p.block_kv) * KV * B
    G = p.grid[0]
    out = []
    for cta in range(G):
        mine, r = [], 0
        while True:
            w = r * G + (G - 1 - cta if r & 1 else cta)
            if w >= n_items:
                break
            mine.append((w // (KV * B) * p.block_kv, w % KV, w // KV % B))
            r += 1
        out.append(mine)
    return out


def bwd_q_blocks(k0: int, block_q: int, Sq: int, causal: bool,
                 q_offset: int) -> range:
    """The q blocks (by index) that the backward visits for the key block
    starting at ``k0``: from the first that holds a row seeing key k0 under
    the causal mask (none if no row below Sq does), to the last.  The
    kernels compute the same."""
    first_row = max(0, k0 - q_offset) if causal else 0
    n_qb = -(-Sq // block_q)
    return range(first_row // block_q if first_row < Sq else n_qb, n_qb)


def bwd_tile_masked(kw0: int, q0: int, Skv: int, causal: bool,
                    q_offset: int, keys: int = 64) -> bool:
    """Whether a ``wgmma`` backward consumer masks its tile of ``keys`` keys
    from ``kw0`` against the q block from row ``q0``: when it holds a key at
    or past Skv, or (causal) its smallest q position lies below its largest
    key.  Rows past Sq need no mask (their lse is +inf, so P = 0).  The
    kernel computes the same."""
    return kw0 + keys > Skv or (causal and q_offset + q0 < kw0 + keys - 1)


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
                         return_lse: bool = False,
                         variant: Optional[str] = None):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd), and
    with ``return_lse`` also the rows' log-sum-exp (B, H, Sq) f32.
    ``variant``: ``plan``'s (None: from the shape)."""
    _build.plain("flash_attention_cuda", q, k, v)
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
    p = plan(q.dtype, hd, B, Sq, H, _build.sm_count(q.device.index),
             Skv=Skv, KV=KV, causal=causal, q_offset=int(q_offset),
             variant=variant)
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
    _build.plain("flash_attention_bwd_cuda", *ts)
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
    p = bwd_plan(q.dtype, hd, B, Skv, KV, _build.sm_count(q.device.index))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return torch.zeros_like(q), dk.zero_(), dv.zero_()
    # f32 dQ sums, zeroed by the kernels' D pass.
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
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
            float(scale), VARIANTS[p.variant], p.block_q, p.stages, p.threads,
            *p.grid, p.smem_bytes, _build.stream_ptr(q))
    _build.check(lib, err, "flash_attn_bwd")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.variant_launches[p.variant] += 1
    # The cast to bf16 stays a PyTorch op (one elementwise pass over dQ).
    dq = dq_acc if q.dtype == torch.float32 else dq_acc.to(q.dtype)
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.variant_launches = dict.fromkeys(
    ("wgmma", "mma_sync", "fma"), 0)       # the backward has no decode variant
