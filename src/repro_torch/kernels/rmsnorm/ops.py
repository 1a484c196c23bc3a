"""Dispatch on the tensor's device: the CUDA kernel for a CUDA tensor, the
plain version for a CPU tensor (or when ``force_ref`` asks for it, as the
on-card comparisons do).  No fallback: a kernel that cannot run raises."""
from __future__ import annotations

from .kernel import rmsnorm_cuda
from .ref import gated_rmsnorm_ref, rmsnorm_ref


def rmsnorm(x, weight, eps: float = 1e-5, force_ref: bool = False):
    if force_ref or x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps)
    if x.device.type == "cuda":
        return rmsnorm_cuda(x, weight, eps=eps)
    raise ValueError(f"rmsnorm: no path for device {x.device}")


def gated_rmsnorm(x, gate, weight, eps: float = 1e-5):
    # The JAX package has no kernel for it: plain torch on every device.
    return gated_rmsnorm_ref(x, gate, weight, eps=eps)
