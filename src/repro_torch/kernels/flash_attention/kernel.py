"""CUDA flash-attention forward (``csrc/flash_attention.cu``) bound to PyTorch.

Replaces the TPU kernel ``flash_attention_pallas`` (``repro/kernels/
flash_attention/kernel.py``), forward only.  On the H100 it is bound by
tensor FLOPs (4 * B * H * Sq * Skv * hd, about half under the causal mask,
over 989 TFLOP/s bf16).  bf16 inputs run on the tensor cores (warp-level
``mma.sync``, f32 accumulation, scores kept in registers); f32 inputs run
with plain f32 FMA so that nothing is rounded to bf16.  Both skip the KV
tiles the causal mask removes — see the source.
``flash_attention_cuda.launches`` counts launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import _build

HEAD_DIMS = (16, 32, 64, 128)


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
            int(q_offset), float(scale), _build.stream_ptr(q))
    _build.check(lib, err, "flash_attn_fwd")
    flash_attention_cuda.launches += 1
    return o


flash_attention_cuda.launches = 0
