"""Dispatch on the tensor's device: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor (or when ``force_ref`` asks for it, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises."""
from __future__ import annotations

from .kernel import flash_attention_cuda
from .ref import decode_attention_ref, flash_attention_ref


def flash_attention(q, k, v, *, causal=True, q_offset=0, block_kv=1024,
                    softmax_scale=None, force_ref=False):
    if force_ref or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   block_kv=block_kv,
                                   softmax_scale=softmax_scale)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, q_offset=q_offset,
                                    softmax_scale=softmax_scale)
    raise ValueError(f"flash_attention: no path for device {q.device}")


def decode_attention(q, k, v, kv_len, softmax_scale=None):
    # Single-query attention is memory-bound and the JAX package has no
    # kernel for it: plain torch on every device.
    return decode_attention_ref(q, k, v, kv_len, softmax_scale=softmax_scale)
