"""The CUDA SSD chunk kernel's launch plan and arithmetic, on the CPU.

``plan`` (``repro_torch.kernels.ssd.kernel``) lays out one block per
(b*c, 64-row i-tile, group of at most 8 heads), heaviest i-tiles first; the
kernel (``csrc/ssd_chunk.cu``) decodes ``blockIdx.x`` the same way.  The
kernel itself runs only on the card (``chip_smoke.py``); here a plain-torch
emulation of its blocking is held against ``ssd_chunk_ref`` (and, once,
against the JAX package's ``ssd_chunk_pallas`` in interpret mode) at 1e-4,
the tolerance of tests/test_kernels.py: G = C Bᵀ formed once per block and
shared by the group's heads, the decay split at the i-tile's first row on
off-diagonal tiles and taken from the difference on the diagonal one, every
product in 3xTF32 (TF32 rounding emulated on the int32 view, round to
nearest with ties away from zero, as ``cvt.rna``), and the end states
fused into the last i-tile's blocks.

The same emulation with one TF32 product in place of three (``mm1``) misses
``ssd_chunk_ref`` on y by 5.8e-4 at one (b, c) of zamba2's prefill shape
(l 256, h 64, p 64, n 64), by 4.1e-4 at mamba2's (h 32, n 128) and by
1.2e-2 at the reduced shape (B and C unscaled), with these inputs: above the
1e-4 tolerance, the measured ground for the split.  3xTF32 lands at 3.3e-7,
3.0e-7 and 4.8e-6 there.  Those errors are reported, not asserted.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jax_ssd_kernel
from repro_torch.kernels.ssd import ssd_chunk_ref
from repro_torch.kernels.ssd.kernel import (MAX_HEAD_GROUP, N_DIMS, P_DIMS,
                                            SMEM_LIMIT, TILE, plan,
                                            smem_bytes)

SSD_TOL = 1e-4


# ---------------------------------------------------------------- plan


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("l", [16, 48, 200, 256])
@pytest.mark.parametrize("h", [1, 2, 3, 5, 32, 64])
def test_plan_covers_every_tile_and_head_once(h, l):
    b, c = 2, 3
    pl = plan(b, c, l, h, 64, 64)
    blocks = [pl.block(k) for k in range(pl.blocks)]
    seen = [(bc, it, hh) for bc, it, heads in blocks for hh in heads]
    want = [(bc, it, hh) for bc in range(b * c)
            for it in range(-(-l // TILE)) for hh in range(h)]
    assert sorted(seen) == sorted(want)
    # Heaviest i-tiles first: the i-tile never rises along blockIdx.x.
    its = [it for _, it, _ in blocks]
    assert its == sorted(its, reverse=True)
    # ceil(h / 8) groups per (b*c, i-tile), as even as they come; only the
    # last may be ragged, and none is empty.
    assert pl.groups == -(-h // MAX_HEAD_GROUP)
    assert pl.head_group <= MAX_HEAD_GROUP
    sizes = [len(heads) for _, _, heads in blocks[:pl.groups]]
    assert all(s == pl.head_group for s in sizes[:-1])
    assert 1 <= sizes[-1] <= pl.head_group
    assert sum(sizes) == h


def test_plan_at_the_serving_shapes():
    """zamba2 (h 64) and mamba2 (h 32) prefill: 8 heads a group, so C Bᵀ is
    formed 8 and 4 times per (b, c) and 512 / 256 blocks share 132 SMs."""
    z = plan(4, 4, 256, 64, 64, 64)
    m = plan(4, 4, 256, 32, 64, 128)
    assert (z.head_group, z.groups, z.blocks) == (8, 8, 512)
    assert (m.head_group, m.groups, m.blocks) == (8, 4, 256)
    ragged = plan(1, 2, 200, 5, 64, 64)
    assert (ragged.i_tiles, ragged.head_group, ragged.groups) == (4, 5, 1)
    nine = plan(2, 1, 256, 9, 64, 128)
    assert (nine.head_group, nine.groups) == (5, 2)
    assert [len(nine.block(k)[2]) for k in range(2)] == [5, 4]


@pytest.mark.parametrize("p", P_DIMS)
@pytest.mark.parametrize("n", N_DIMS)
def test_shared_memory_fits_a_block(p, n):
    assert smem_bytes(256, p, n) <= SMEM_LIMIT
    assert smem_bytes(16, p, n) < smem_bytes(256, p, n)
    # Smem<64, 128> in csrc/ssd_chunk.cu at l = 256, in floats: the prefix
    # sums, four G tiles, the x halves of two heads, two B tiles.
    assert smem_bytes(256, 64, 128) == 4 * (
        8 * 256 + 4 * 64 * 68 + 4 * 64 * 64 + 2 * 64 * 136)


@pytest.mark.parametrize("l,h,p,n", [(256, 3, 32, 64), (256, 3, 64, 32),
                                     (257, 1, 64, 64), (0, 1, 64, 64),
                                     (64, 0, 64, 64)])
def test_plan_refuses_what_the_kernel_does_not_take(l, h, p, n):
    with pytest.raises(ValueError):
        plan(1, 1, l, h, p, n)


# ---------------------------------------------------------------- arithmetic


def tf32(v: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32``, on the int32 view of the bits."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v):
    hi = tf32(v)
    return hi, tf32(v - hi)


def mm3(a, b):
    """3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (lo lo dropped)."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """One TF32 product, for the record."""
    return tf32(a) @ tf32(b)


def emulate(xc, ac, Bc, Cc, mm=mm3):
    """The kernel's blocking in plain torch: block by block as ``plan`` lays
    them out, G per block shared by the group, the decay split at i0 off the
    diagonal, the row factor applied before the diagonal tile, the states in
    the last i-tile's blocks."""
    b, c, l, h, p = xc.shape
    n = Bc.shape[-1]
    pl = plan(b, c, l, h, p, n)
    L = pl.i_tiles * TILE

    def flat(t, tail):
        t = t.reshape((b * c, l) + tail)
        return torch.nn.functional.pad(t, (0, 0) * len(tail) + (0, L - l))
    x, a = flat(xc, (h, p)), flat(ac, (h,))
    B, C = flat(Bc, (n,)), flat(Cc, (n,))
    y = torch.full((b * c, L, h, p), float("nan"))
    st = torch.full((b * c, h, p, n), float("nan"))
    rows = torch.arange(TILE)
    mask = rows[None, :] <= rows[:, None]                  # j <= i
    for k in range(pl.blocks):
        bc, it, heads = pl.block(k)
        hs = list(heads)
        i0, last = it * TILE, it == pl.i_tiles - 1
        cum = torch.cumsum(a[bc][:, hs], dim=0).T           # (nh, L)
        ci0 = cum[:, i0:i0 + 1]
        G = [mm(C[bc, i0:i0 + TILE], B[bc, j * TILE:(j + 1) * TILE].T)
             for j in range(it + 1)]                        # shared by heads
        X = x[bc][:, hs].permute(1, 0, 2)                   # (nh, L, p)
        yacc = torch.zeros(len(hs), TILE, p)
        sacc = torch.zeros(len(hs), n, p)
        for jt in range(it):
            js = slice(jt * TILE, (jt + 1) * TILE)
            xs = X[:, js] * torch.exp(ci0 - cum[:, js])[..., None]
            yacc += mm(G[jt], xs)
            if last:
                sacc += mm(B[bc, js].T, xs)
        ii = slice(i0, i0 + TILE)
        yacc *= torch.exp(cum[:, ii] - ci0)[..., None]
        if last:
            sacc *= torch.exp(cum[:, l - 1:l] - ci0)[..., None]
        diff = cum[:, ii, None] - cum[:, None, ii]
        S = torch.where(mask, G[it] * torch.exp(torch.where(mask, diff, 0.)),
                        0.)
        yacc += mm(S, X[:, ii])
        y[bc, ii, hs] = yacc.permute(1, 0, 2)
        if last:
            dec = torch.exp(cum[:, l - 1:l] - cum[:, ii])     # (nh, 64)
            sacc += mm((B[bc, ii][None] * dec[..., None]).transpose(1, 2),
                       X[:, ii])
            st[bc, hs] = sacc.transpose(1, 2)
    return (y[:, :l].reshape(b, c, l, h, p), st.reshape(b, c, h, p, n))


def ssd_inputs(shape, scale_bc, seed=0, decay=0.1):
    """tests/test_kernels.py's inputs from numpy: x * 0.5, a = -|N| * decay,
    B and C scaled by ``scale_bc``."""
    b, c, l, h, p, n = shape
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (t(b, c, l, h, p) * 0.5, -t(b, c, l, h).abs() * decay,
            t(b, c, l, n) * scale_bc, t(b, c, l, n) * scale_bc)


# (b, c, l, h, p, n, B/C scale): the reduced configs, tests/test_kernels.py's
# shape, ragged chunks and head groups, and one (b, c) of zamba2's and
# mamba2's prefill.
EMULATED = {"reduced": (2, 2, 32, 8, 16, 16, 1.0),
            "jax_test": (1, 4, 16, 2, 16, 8, 1.0),
            "ragged_48": (1, 3, 48, 3, 16, 16, 1.0),
            "ragged_200_h5": (1, 2, 200, 5, 64, 64, 64 ** -0.5),
            "h9_n128": (1, 1, 256, 9, 64, 128, 128 ** -0.5),
            "zamba2_bc": (1, 1, 256, 64, 64, 64, 64 ** -0.5),
            "mamba2_bc": (1, 1, 256, 32, 64, 128, 128 ** -0.5)}


def max_err(got, want):
    assert bool(torch.isfinite(got).all())
    return float((got - want).abs().max())


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_blocking_matches_ssd_chunk_ref(case):
    *shape, scale = EMULATED[case]
    xc, ac, Bc, Cc = ssd_inputs(shape, scale)
    y, st = emulate(xc, ac, Bc, Cc)
    y_ref, st_ref = ssd_chunk_ref(xc, ac, Bc, Cc)
    assert y.shape == y_ref.shape and st.shape == st_ref.shape
    assert max_err(y, y_ref) <= SSD_TOL
    assert max_err(st, st_ref) <= SSD_TOL


@pytest.mark.parametrize("decay", [3.0, 30.0])
def test_emulated_blocking_under_strong_decay(decay):
    """Decays that underflow exp(cum_i - cum_j) far off the diagonal: the
    split factors stay <= 1, so nothing overflows and no NaN appears."""
    xc, ac, Bc, Cc = ssd_inputs((1, 2, 256, 3, 16, 16), 0.25, seed=3,
                                decay=decay)
    y, st = emulate(xc, ac, Bc, Cc)
    y_ref, st_ref = ssd_chunk_ref(xc, ac, Bc, Cc)
    assert max_err(y, y_ref) <= SSD_TOL
    assert max_err(st, st_ref) <= SSD_TOL


def test_emulated_blocking_matches_pallas_interpret():
    xc, ac, Bc, Cc = ssd_inputs((1, 2, 48, 3, 16, 16), 1.0, seed=5)
    y_want, st_want = jax.jit(jax_ssd_kernel.ssd_chunk_pallas,
                              static_argnames=("interpret",))(
        *(t.numpy() for t in (xc, ac, Bc, Cc)), interpret=True)
    y, st = emulate(xc, ac, Bc, Cc)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), atol=SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_want), atol=SSD_TOL)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                           # TF32's spacing at 1
    v = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    assert tf32(v).tolist() == [one + ulp, -(one + ulp), one, one + 2 * ulp,
                                3.0]
    hi, lo = split(torch.tensor([1 / 3], dtype=torch.float32))
    assert abs(float(hi + lo) - 1 / 3) < 2 ** -22
