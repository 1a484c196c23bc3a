"""CUDA SSD intra-chunk block (``csrc/ssd_chunk.cu``) bound to PyTorch.

Replaces the TPU kernel ``ssd_chunk_pallas`` (``repro/kernels/ssd/
kernel.py:44``).  Per (b, c): G = C Bᵀ over the chunk, shared by every
head; per head y = (G ∘ exp(segsum a)) x and the end state (B ∘ decay)ᵀ x.

One launch: a CTA per (b*c, 64-row i-tile, group of up to 8 heads), the
heaviest i-tiles first (``plan``; the kernel decodes ``blockIdx.x`` the
same way).  The CTA forms its row block of G once and reuses it for every
head of its group, so C Bᵀ is computed ceil(h / 8) times per (b, c), not h
times; the CTA of the last i-tile also writes the end states from the x
tiles it converts anyway.  Every product runs on the tensor cores in
3xTF32 (y and the states on ``wgmma``, G on ``mma.sync``): each f32
operand is split into two TF32 parts and three products are summed, which
keeps the 1e-4 f32 tolerance that one TF32 product misses.  With the
products there, the kernel is bound by bytes at zamba2's shape (b4 c4 l256
h64 p64 n64) and sits at the bytes/operations ridge at mamba2's (h32
n128).  ``ssd_chunk_cuda.launches`` counts launches (one a call).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build

P_DIMS = (16, 64)              # head dim p
N_DIMS = (8, 16, 64, 128)      # state n
MAX_L = 256                    # chunk length
TILE = 64                      # rows of an i- or j-tile
MAX_HEAD_GROUP = 8             # heads that share one CTA's G
SMEM_LIMIT = 232448 - 256      # dynamic shared memory a block may use (H100),
                               # less the kernel's static `wsum`


@dataclass(frozen=True)
class SsdPlan:
    """How one launch is laid out: i-tiles per chunk, heads per group
    (``head_group``; the last group may hold fewer of the ``h`` heads),
    groups per (b, c), the number of blocks and dynamic shared memory in
    bytes."""
    i_tiles: int
    head_group: int
    groups: int
    bc: int
    h: int
    blocks: int
    smem_bytes: int

    def block(self, k: int) -> tuple:
        """(b*c index, i-tile, heads) of block ``k`` as ``ssd_chunk_kernel``
        decodes ``blockIdx.x``: the i-tile slowest and heaviest first, then
        b*c, then the head group."""
        per_tile = self.bc * self.groups
        it = self.i_tiles - 1 - k // per_tile
        rem = k % per_tile
        h0 = rem % self.groups * self.head_group
        return rem // self.groups, it, range(h0, min(h0 + self.head_group,
                                                     self.h))


def smem_bytes(l: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block, as ``Smem`` in csrc/ssd_chunk.cu:
    the prefix sums of 8 heads, one G tile per i-tile (rows padded by 4), the
    TF32 halves of two heads' x tiles (or the C tile, rows padded by 4, if
    larger) and two B tiles (rows padded by 8).

    A mirror, for tests on the CPU: the kernel sizes its launch from
    ``Smem::bytes``, whose ``static_assert`` against the block limit is the
    real guard; ``chip_smoke.py`` holds this mirror equal to the kernel's own
    count (``ssd_chunk_smem_bytes``) at every case it runs."""
    i_tiles = -(-l // TILE)
    floats = (MAX_HEAD_GROUP * MAX_L + i_tiles * TILE * (TILE + 4)
              + max(4 * TILE * p, TILE * (n + 4)) + 2 * TILE * (n + 8))
    return 4 * floats


def plan(b: int, c: int, l: int, h: int, p: int, n: int) -> SsdPlan:
    """The launch plan for xc (b, c, l, h, p), Bc (b, c, l, n): groups of at
    most 8 heads, as even as they come (a ragged last group is masked)."""
    if p not in P_DIMS or n not in N_DIMS or not 1 <= l <= MAX_L or h < 1:
        raise ValueError(f"ssd_chunk_cuda: p {p} not in {P_DIMS}, n {n} not "
                         f"in {N_DIMS}, l {l} not in [1, {MAX_L}] or h {h} < 1")
    i_tiles = -(-l // TILE)
    groups = -(-h // MAX_HEAD_GROUP)
    head_group = -(-h // groups)
    return SsdPlan(i_tiles, head_group, groups, b * c, h,
                   i_tiles * b * c * groups, smem_bytes(l, p, n))


def ssd_chunk_cuda(xc: torch.Tensor, ac: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor):
    """xc (b, c, l, h, p); ac (b, c, l, h); Bc, Cc (b, c, l, n); all f32 and
    contiguous.  Returns (y_diag (b, c, l, h, p), states (b, c, h, p, n)).

    ``ac`` is a decay, a = dt * A <= 0 (A < 0, dt > 0, as Mamba2 has it): the
    kernel splits exp(cum_i - cum_j) off the diagonal tile at the tile's
    first row into two factors <= 1, which a growing ``ac`` could overflow."""
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
    y = torch.empty_like(xc)
    st = torch.empty((b, c, h, p, n), dtype=torch.float32, device=xc.device)
    if b * c == 0 or h == 0:
        return y, st
    plan(b, c, l, h, p, n)             # raises on what no kernel takes
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_chunk_cuda: inputs must be contiguous")
    if not _build.aligned16(xc, Bc, Cc):
        raise ValueError("ssd_chunk_cuda: xc, Bc, Cc must be 16-byte aligned")
    lib = _build.load()
    with torch.cuda.device(xc.device):
        err = lib.ssd_chunk_fwd(xc.data_ptr(), ac.data_ptr(), Bc.data_ptr(),
                                Cc.data_ptr(), y.data_ptr(), st.data_ptr(),
                                b * c, l, h, p, n, _build.stream_ptr(xc))
    _build.check(lib, err, "ssd_chunk_fwd")
    ssd_chunk_cuda.launches += 1
    return y, st


ssd_chunk_cuda.launches = 0
