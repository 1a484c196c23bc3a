"""CUDA RMSNorm forward and backward (``csrc/rmsnorm.cu``) bound to PyTorch.

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
MAX_BWD_VECS = 512      # 16-byte vectors a row: d <= 4096 bf16, 2048 f32
BWD_THREADS = 256


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


def rmsnorm_bwd_parts(rows: int, d: int, itemsize: int, sms: int = 132) -> int:
    """CTAs (and f32 rows of dw partials) of one backward launch: as many as
    the rows fill, at most two an SM.  A row takes 8, 16 or 32 lanes, as
    ``launch_bwd`` in csrc/rmsnorm.cu picks them."""
    nvec = d * itemsize // 16
    lanes = 8 if nvec <= 8 else (16 if nvec <= 16 else 32)
    rows_per_cta = BWD_THREADS // 32 * (32 // lanes)
    return max(1, min(-(-rows // rows_per_cta), 2 * sms))


def rmsnorm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5):
    """(dx, dw) of ``rmsnorm_cuda`` at ``dy``: dx like x, dw like weight."""
    if not (x.is_cuda and weight.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda: x, weight and dy must be on one "
                         f"CUDA device (got {x.device}, {weight.device}, "
                         f"{dy.device})")
    if (x.dtype not in _build.DTYPE_CODES
            or not x.dtype == weight.dtype == dy.dtype):
        raise TypeError("rmsnorm_bwd_cuda: x, weight and dy must all be "
                        f"float32 or bfloat16 (got {x.dtype}, {weight.dtype}, "
                        f"{dy.dtype})")
    d = x.shape[-1]
    if weight.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd_cuda: weight {tuple(weight.shape)}, dy "
                         f"{tuple(dy.shape)} vs x {tuple(x.shape)}")
    nbytes = d * x.element_size()
    if nbytes % 16 or nbytes // 16 > MAX_BWD_VECS:
        raise ValueError(f"rmsnorm_bwd_cuda: a row of {d} x {x.dtype} must be "
                         f"a multiple of 16 bytes and at most {MAX_BWD_VECS} "
                         "of them")
    if not (x.is_contiguous() and weight.is_contiguous()
            and dy.is_contiguous()):
        raise ValueError("rmsnorm_bwd_cuda: x, weight and dy must be "
                         "contiguous")
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    rows = x.numel() // d
    if rows == 0:
        return dx, dw.zero_()
    if not _build.aligned16(x, weight, dy, dx, dw):
        raise ValueError("rmsnorm_bwd_cuda: tensors must be 16-byte aligned")
    parts = rmsnorm_bwd_parts(rows, d, x.element_size(),
                              _build.sm_count(x.device.index))
    dw_part = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_bwd(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), dw.data_ptr(), dw_part.data_ptr(),
                              parts, rows, d, float(eps),
                              _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(lib, err, "rmsnorm_bwd")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0
