"""Plain PyTorch RMSNorm (f32 accumulation, bf16 in/out) and its gradient —
the CPU path and the references the CUDA kernels are held against.  The
forward has the arithmetic of ``repro.kernels.rmsnorm.ref``; the backward
is what ``jax.grad`` of it computes, written out."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5):
    """Gradients (dx, dw) of ``rmsnorm_ref`` at ``dy``, in f32: r =
    1/sqrt(mean(x^2)+eps), x^ = x r, g = dy w, dx = r (g - x^ mean(g x^)),
    dw = sum over rows of dy x^; cast back to x's and w's types."""
    xf, wf, gf = x.float(), weight.float(), dy.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.reciprocal(torch.sqrt(var + eps))
    xh = xf * r
    g = gf * wf
    dx = r * (g - xh * torch.mean(g * xh, dim=-1, keepdim=True))
    dw = (gf * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def gated_rmsnorm_ref(x: torch.Tensor, gate: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-5):
    """Mamba2's out-norm: rmsnorm(x * silu(gate)) variant (norm-then-gate)."""
    xf = x.float()
    g = gate.float()
    xf = xf * (g * torch.reciprocal(1.0 + torch.exp(-g)))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
