"""CUDA SSD intra-chunk block (``csrc/ssd_chunk.cu``) bound to PyTorch.

Replaces the TPU kernel ``ssd_chunk_pallas`` (``repro/kernels/ssd/
kernel.py``).  On the H100 it is bound by f32 operations: per (b, c) the
score C Bᵀ over the l(l+1)/2 pairs the mask keeps, and per (b, c, h) the
masked product with x and the chunk's end state, over 67 TFLOP/s.  One CTA
per (b*c, h, 64-row tile) forms 64 x 64 score tiles with f32 FMA, scales them
by exp(cum_i - cum_j) for j <= i only, and accumulates y in registers; a
second small kernel writes the end states.  See the source for the rest.
``ssd_chunk_cuda.launches`` counts calls (each launches both kernels).
"""
from __future__ import annotations

import torch

from .. import _build

P_DIMS = (16, 64)              # head dim p
N_DIMS = (8, 16, 64, 128)      # state n
MAX_L = 256                    # chunk length
MAX_GRID = 65535               # b*c and h ride grid dimensions y / z


def ssd_chunk_cuda(xc: torch.Tensor, ac: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor):
    """xc (b, c, l, h, p); ac (b, c, l, h); Bc, Cc (b, c, l, n); all f32 and
    contiguous.  Returns (y_diag (b, c, l, h, p), states (b, c, h, p, n))."""
    tensors = (xc, ac, Bc, Cc)
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("ssd_chunk_cuda: xc, ac, Bc, Cc must be on one CUDA "
                         f"device (got {[str(t.device) for t in tensors]})")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("ssd_chunk_cuda: inputs must be float32 (got "
                        f"{[t.dtype for t in tensors]})")
    if xc.dim() != 5 or Bc.dim() != 4:
        raise ValueError(f"ssd_chunk_cuda: bad ranks xc {tuple(xc.shape)} "
                         f"Bc {tuple(Bc.shape)}")
    b, c, l, h, p = xc.shape
    n = Bc.shape[-1]
    if (ac.shape != (b, c, l, h) or Bc.shape != (b, c, l, n)
            or Cc.shape != Bc.shape):
        raise ValueError(f"ssd_chunk_cuda: shapes do not match: xc "
                         f"{tuple(xc.shape)} ac {tuple(ac.shape)} Bc "
                         f"{tuple(Bc.shape)} Cc {tuple(Cc.shape)}")
    if p not in P_DIMS or n not in N_DIMS or not 1 <= l <= MAX_L:
        raise ValueError(f"ssd_chunk_cuda: p {p} not in {P_DIMS}, n {n} not "
                         f"in {N_DIMS}, or l {l} not in [1, {MAX_L}]")
    if b * c > MAX_GRID or h > MAX_GRID:
        raise ValueError(f"ssd_chunk_cuda: b*c {b * c} or h {h} above "
                         f"{MAX_GRID}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunk_cuda: inputs must be contiguous")
    y = torch.empty_like(xc)
    st = torch.empty((b, c, h, p, n), dtype=torch.float32, device=xc.device)
    if b * c == 0 or h == 0:
        return y, st
    lib = _build.load()
    with torch.cuda.device(xc.device):
        err = lib.ssd_chunk_fwd(xc.data_ptr(), ac.data_ptr(), Bc.data_ptr(),
                                Cc.data_ptr(), y.data_ptr(), st.data_ptr(),
                                b * c, l, h, p, n, _build.stream_ptr(xc))
    _build.check(lib, err, "ssd_chunk_fwd")
    ssd_chunk_cuda.launches += 1
    return y, st


ssd_chunk_cuda.launches = 0
