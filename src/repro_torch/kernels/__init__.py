"""Hand-written Hopper kernels for the port's hot spots.

Each kernel ships three layers, as in ``repro.kernels``: ``kernel.py`` (the
CUDA wrapper over ``csrc/*.cu``, with a ``launches`` counter), ``ops.py``
(dispatch on the tensor's device) and ``ref.py`` (plain PyTorch, the CPU path
and the on-card reference).  ``_build.py`` compiles ``csrc/`` at first launch.
"""
from .flash_attention import decode_attention, flash_attention
from .rmsnorm import gated_rmsnorm, rmsnorm
from .ssd import ssd, ssd_decode

__all__ = ["decode_attention", "flash_attention", "gated_rmsnorm", "rmsnorm",
           "ssd", "ssd_decode"]
