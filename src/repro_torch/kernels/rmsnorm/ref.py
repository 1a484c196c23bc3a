"""Plain PyTorch RMSNorm (f32 accumulation, bf16 in/out) — the CPU path and
the reference the CUDA kernel is held against.  Same arithmetic as
``repro.kernels.rmsnorm.ref``."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def gated_rmsnorm_ref(x: torch.Tensor, gate: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-5):
    """Mamba2's out-norm: rmsnorm(x * silu(gate)) variant (norm-then-gate)."""
    xf = x.float()
    g = gate.float()
    xf = xf * (g * torch.reciprocal(1.0 + torch.exp(-g)))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
