"""Dispatch on the tensor's device: the CUDA kernels for a CUDA tensor, the
plain versions for a CPU tensor (or when ``force_ref`` asks for them, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises.

``rmsnorm`` is a ``torch.autograd.Function``: its backward dispatches the
same way (``rmsnorm_bwd_cuda`` or ``rmsnorm_bwd_ref``) and recomputes r
from the saved x and weight."""
from __future__ import annotations

import torch

from .kernel import rmsnorm_bwd_cuda, rmsnorm_cuda
from .ref import gated_rmsnorm_ref, rmsnorm_bwd_ref, rmsnorm_ref


def _plain(x, force_ref: bool) -> bool:
    if force_ref or x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"rmsnorm: no path for device {x.device}")


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps, force_ref):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.plain = eps, _plain(x, force_ref)
        if ctx.plain:
            return rmsnorm_ref(x, weight, eps=eps)
        return rmsnorm_cuda(x, weight, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = rmsnorm_bwd_ref if ctx.plain else rmsnorm_bwd_cuda
        dx, dw = bwd(x, weight, dy, eps=ctx.eps)
        return dx, dw, None, None


def rmsnorm(x, weight, eps: float = 1e-5, force_ref: bool = False):
    return _RMSNorm.apply(x, weight, eps, force_ref)


def gated_rmsnorm(x, gate, weight, eps: float = 1e-5):
    # The JAX package has no kernel for it: plain torch on every device.
    return gated_rmsnorm_ref(x, gate, weight, eps=eps)
