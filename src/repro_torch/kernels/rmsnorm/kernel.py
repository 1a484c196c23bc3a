"""CUDA RMSNorm forward and backward (``csrc/rmsnorm.cu``) bound to PyTorch.

Replaces the TPU kernel ``rmsnorm_pallas`` (``repro/kernels/rmsnorm/
kernel.py``).  On the H100 it is bound by bytes: one read and one write of
the row (2 * rows * d * itemsize over 3.35 TB/s).  Where the row allows
16-byte vectors and d <= 8192 bf16 (4096 f32), 8 to 32 lanes hold a whole
row in registers, reduce x^2 in f32 with shuffles and write the result from
the same registers, over a grid-stride loop that keeps the weight in
registers; longer rows take one CTA per row.  See the source for the rest.
``rmsnorm_cuda.launches`` counts launches.

The backward (``rmsnorm_bwd_cuda``, bound by bytes: x and dy read, dx
written) spreads a row over up to 256 threads of one or two vectors each,
at most 64 registers a thread, on a one-wave persistent grid
(``rmsnorm_bwd_plan``) that prefetches the next row by ``cp.async``; dw
folds into one f32 row by ``red.global.add`` and the last CTA casts it.
Rows of more than 512 vectors (d up to 8192 in either type: llama-3.2-
vision's d_model) take a CTA of 256 threads a row, 4 or 8 vectors a
thread, two CTAs an SM; rows wider than 8192 (up to MAX_D: mistral-large's
12288, llama3-405b's 16384) a CTA of 512 threads of 32 elements a row, one
CTA an SM, the next row staged through shared memory by ``cp.async``.
``rmsnorm_bwd_cuda.launches`` counts its calls.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

MAX_D = 16384
MAX_BWD_D = MAX_D       # the backward's widest row, in either type
BWD_ROW_VECS = 512      # 16-byte vectors a row of the row-group kernel
BWD_THREADS = 256
BWD_CTAS_PER_SM = 4     # csrc/rmsnorm.cu kBwdCtasPerSm
BWD_LONG_CTAS_PER_SM = 2  # csrc/rmsnorm.cu kBwdLongCtasPerSm
BWD_LONG_D = 8192       # the long-row kernel's widest row; wider: the wide one
BWD_WIDE_THREADS = 512  # csrc/rmsnorm.cu kBwdWideThreads
BWD_WIDE_ELEMS = 32     # csrc/rmsnorm.cu kBwdWideElems: row elements a thread
BWD_WIDE_CTAS_PER_SM = 1  # csrc/rmsnorm.cu kBwdWideCtasPerSm
BWD_DW_ROWS = 8         # csrc/rmsnorm.cu kDwRows


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    _build.plain("rmsnorm_cuda", x, weight)
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


class RmsNormBwdPlan(NamedTuple):
    """One backward launch: 16-byte vectors per thread, threads per row, row
    groups per CTA and CTAs."""
    vecs: int
    lanes: int
    groups: int
    grid: int


def rmsnorm_bwd_plan(rows: int, d: int, itemsize: int,
                     sms: int = 132) -> RmsNormBwdPlan:
    """The backward's launch, as ``launch_bwd`` in csrc/rmsnorm.cu lays it
    out: a row of ``nvec`` 16-byte vectors takes the fewest threads (at least
    8) that leave each one vector, up to a warp, then two vectors a thread
    over up to 256 threads; the grid is as many CTAs as the row groups fill,
    at most the BWD_CTAS_PER_SM an SM that the kernel's register bound lets
    fit (one wave).  A row of more than BWD_ROW_VECS vectors takes the
    long-row kernel: a CTA of BWD_THREADS threads, 4 vectors a thread (8
    past 1024 vectors), BWD_LONG_CTAS_PER_SM CTAs an SM; a row wider than
    BWD_LONG_D the wide-row kernel: a CTA of BWD_WIDE_THREADS threads of
    BWD_WIDE_ELEMS elements (4 bf16 or 8 f32 vectors), BWD_WIDE_CTAS_PER_SM
    an SM.  A row wider than MAX_BWD_D raises, as the launch refuses it."""
    if d > MAX_BWD_D:
        raise ValueError(f"rmsnorm_bwd_plan: no backward kernel takes rows "
                         f"of {d} (at most {MAX_BWD_D})")
    nvec = d * itemsize // 16
    if d > BWD_LONG_D:
        return RmsNormBwdPlan(BWD_WIDE_ELEMS * itemsize // 16,
                              BWD_WIDE_THREADS, 1,
                              max(1, min(rows, BWD_WIDE_CTAS_PER_SM * sms)))
    if nvec > BWD_ROW_VECS:
        return RmsNormBwdPlan(4 if nvec <= 1024 else 8, BWD_THREADS, 1,
                              max(1, min(rows, BWD_LONG_CTAS_PER_SM * sms)))
    vecs, lanes = next((v, t) for top, v, t in (
        (8, 1, 8), (16, 1, 16), (32, 1, 32), (64, 2, 32), (128, 2, 64),
        (256, 2, 128), (512, 2, 256)) if nvec <= top)
    groups = BWD_THREADS // lanes
    return RmsNormBwdPlan(vecs, lanes, groups, max(1, min(
        -(-rows // groups), BWD_CTAS_PER_SM * sms)))


def rmsnorm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5):
    """(dx, dw) of ``rmsnorm_cuda`` at ``dy``: dx like x, dw like weight."""
    _build.plain("rmsnorm_bwd_cuda", x, weight, dy)
    if (x.dtype not in _build.DTYPE_CODES
            or not x.dtype == weight.dtype == dy.dtype):
        raise TypeError("rmsnorm_bwd_cuda: x, weight and dy must all be "
                        f"float32 or bfloat16 (got {x.dtype}, {weight.dtype}, "
                        f"{dy.dtype})")
    d = x.shape[-1]
    if weight.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd_cuda: weight {tuple(weight.shape)}, dy "
                         f"{tuple(dy.shape)} vs x {tuple(x.shape)}")
    if (d * x.element_size()) % 16 or d > MAX_BWD_D:
        raise ValueError(f"rmsnorm_bwd_cuda: a row of {d} x {x.dtype} must be "
                         f"a multiple of 16 bytes and at most {MAX_BWD_D} "
                         "wide")
    if not (x.is_cuda and weight.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda: x, weight and dy must be on one "
                         f"CUDA device (got {x.device}, {weight.device}, "
                         f"{dy.device})")
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
    p = rmsnorm_bwd_plan(rows, d, x.element_size(),
                         _build.sm_count(x.device.index))
    # dw's f32 sums (BWD_DW_ROWS rows the CTAs spread their reduce-adds
    # over) and the CTAs' finish counter, zeroed by the launcher right before
    # the kernel; the last CTA sums and casts dw.
    ws = torch.empty(BWD_DW_ROWS * d + 4, dtype=torch.float32,
                     device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.rmsnorm_bwd(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                              p.grid, rows, d, float(eps),
                              _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x))
    _build.check(lib, err, "rmsnorm_bwd")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0
