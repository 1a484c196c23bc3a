"""PyTorch/CUDA port of the serving path of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors its module
names (``configs``, ``models``, ``kernels``, ``serve``) and imports nothing of
it, nor JAX.  Every entry point runs on ``device="cuda"`` unless the caller
asks for the CPU, and raises when CUDA is absent instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is
    none (no silent CPU fallback).  ``meta`` (shapes and dtypes, no data) is
    the dry-run's device: a step traced there executes nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor.  The class is looked up only once
    ``torch.distributed.tensor`` is loaded (before that nothing can be
    one), so a plain caller never imports it."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


__all__ = ["is_dtensor", "resolve_device"]
