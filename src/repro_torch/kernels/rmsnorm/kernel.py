"""CUDA RMSNorm forward (``csrc/rmsnorm.cu``) bound to PyTorch.

Replaces the TPU kernel ``rmsnorm_pallas`` (``repro/kernels/rmsnorm/
kernel.py``).  On the H100 it is bound by bytes: one read and one write of
the row (2 * rows * d * itemsize over 3.35 TB/s).  Where the row allows
16-byte vectors and d <= 8192 bf16 (4096 f32), 8 to 32 lanes hold a whole
row in registers, reduce x^2 in f32 with shuffles and write the result from
the same registers, over a grid-stride loop that keeps the weight in
registers; longer rows take one CTA per row.  See the source for the rest.
``rmsnorm_cuda.launches`` counts launches.
"""
from __future__ import annotations

import torch

from .. import _build

MAX_D = 16384


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    if not x.is_cuda or weight.device != x.device:
        raise ValueError("rmsnorm_cuda: x and weight must be on one CUDA "
                         f"device (got {x.device}, {weight.device})")
    if x.dtype not in _build.DTYPE_CODES or weight.dtype != x.dtype:
        raise TypeError("rmsnorm_cuda: x and weight must both be float32 or "
                        f"bfloat16 (got {x.dtype}, {weight.dtype})")
    d = x.shape[-1]
    if weight.shape != (d,) or not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm_cuda: weight {tuple(weight.shape)} vs x "
                         f"{tuple(x.shape)}; d must be in [1, {MAX_D}]")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm_cuda: x and weight must be contiguous")
    y = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return y
    vec = _build.aligned16(x, weight, y) and (d * x.element_size()) % 16 == 0
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_fwd(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                              rows, d, float(eps), _build.DTYPE_CODES[x.dtype],
                              int(vec), _build.stream_ptr(x))
    _build.check(lib, err, "rmsnorm_fwd")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0
