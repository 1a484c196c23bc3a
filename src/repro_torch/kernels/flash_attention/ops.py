"""Dispatch on the tensor's device: the CUDA kernels for a CUDA tensor, the
plain versions for a CPU tensor (or when ``force_ref`` asks for them, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises.

``flash_attention`` is a ``torch.autograd.Function``: the forward keeps the
rows' log-sum-exp beside q, k, v and o, and the backward dispatches the same
way (``flash_attention_bwd_cuda`` or ``flash_attention_bwd_ref``)."""
from __future__ import annotations

import torch

from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import (decode_attention_ref, flash_attention_bwd_ref,
                  flash_attention_ref)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_kv, softmax_scale,
                force_ref):
        if force_ref or q.device.type == "cpu":
            ctx.plain = True
            o, lse = flash_attention_ref(
                q, k, v, causal=causal, q_offset=q_offset, block_kv=block_kv,
                softmax_scale=softmax_scale, return_lse=True)
        elif q.device.type == "cuda":
            ctx.plain = False
            o, lse = flash_attention_cuda(
                q, k, v, causal=causal, q_offset=q_offset,
                softmax_scale=softmax_scale, return_lse=True)
        else:
            raise ValueError(f"flash_attention: no path for device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset, ctx.scale = causal, q_offset, softmax_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # Autograd may hand over a non-contiguous grad; the kernel refuses one.
        do = do.contiguous()
        if ctx.plain:
            grads = flash_attention_bwd_ref(q, k, v, o, lse, do,
                                            causal=ctx.causal,
                                            q_offset=ctx.q_offset,
                                            scale=ctx.scale)
        else:
            grads = flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=ctx.causal,
                                             q_offset=ctx.q_offset,
                                             softmax_scale=ctx.scale)
        return (*grads, None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, q_offset=0, block_kv=1024,
                    softmax_scale=None, force_ref=False):
    return _FlashAttention.apply(q, k, v, causal, q_offset, block_kv,
                                 softmax_scale, force_ref)


def decode_attention(q, k, v, kv_len, softmax_scale=None):
    # Single-query attention is memory-bound and the JAX package has no
    # kernel for it: plain torch on every device.
    return decode_attention_ref(q, k, v, kv_len, softmax_scale=softmax_scale)
