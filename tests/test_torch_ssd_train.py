"""The SSD chunk's gradient in the port, on the CPU.

``ssd_chunk_bwd_ref`` (explicit formulas, no autograd) is held against the
JAX package's Pallas kernel itself, ``ssd_chunk_pallas`` in interpret mode,
by the adjoint identity <u, J v> = <Jᵀ u, v>: J v from ``jax.jvp`` (its
``jax.vjp`` fails, "Linearization failed"), Jᵀ u from the port; and against
``torch.autograd`` of ``ssd_chunk_ref``.  The autograd Function
``ssd_chunk``, composed by ``ssd_chunked`` with the recurrence across
chunks, is held against ``jax.vjp`` of the JAX package's ``ssd_ref``.  The
CUDA backward (``csrc/ssd_chunk_bwd.cu``) runs only on the card
(``chip_smoke.py``); here its launch plan, its shared-memory mirror and a
plain-torch emulation of its blocking (8-head groups, the transposed
j-tile products in 3xTF32, the per-group partials of dG, of dB's state
part and of the dcum rows, summed by the two finishing kernels in the same
order) are checked.

Inputs come from numpy seeds (x * 0.5, a = -|N| * 0.1, B and C scaled, as
tests/test_kernels.py).  Tolerances, f32: 1e-4 (the SSD tolerance of
tests/test_kernels.py) of each gradient's largest magnitude; the adjoint
identity at 1e-4 of the sum of the absolute terms of <Jᵀ u, v>.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd import kernel as jax_ssd_kernel
from repro.kernels.ssd import ref as jax_ssd
from repro_torch.kernels.ssd import (ssd, ssd_chunk, ssd_chunk_bwd_cuda,
                                     ssd_chunk_bwd_ref, ssd_chunk_cuda,
                                     ssd_chunk_ref, ssd_chunked)
from repro_torch.kernels.ssd.kernel import (BWD_HEAD_GROUP, MAX_L, N_DIMS,
                                            P_DIMS, TILE, bwd_plan,
                                            bwd_smem_bytes)
from test_torch_ssd_plan import mm1, mm3

TOL = 1e-4
# (b, c, l, h, p, n): tests/test_torch_ssm.py's CHUNK_SHAPES.
CHUNK_SHAPES = {"jax_test": (1, 4, 16, 2, 16, 8),
                "reduced": (2, 2, 32, 8, 16, 16),
                "ragged_48": (1, 2, 48, 3, 16, 16)}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores;
    restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def chunk_inputs(shape, scale_bc=1.0, seed=0):
    """(x, a, B, C, dy, dstates) as f32 numpy arrays."""
    b, c, l, h, p, n = shape
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.normal(size=s).astype(np.float32)
    return (r(b, c, l, h, p) * 0.5, -np.abs(r(b, c, l, h)) * 0.1,
            r(b, c, l, n) * scale_bc, r(b, c, l, n) * scale_bc,
            r(b, c, l, h, p), r(b, c, h, p, n))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def leaf_close(got, want, tol=TOL, what=""):
    """Within ``tol`` of the gradient's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


# ------------------------------------------------------- the plain version

pallas_jvp = jax.jit(lambda p, t: jax.jvp(
    lambda *a: jax_ssd_kernel.ssd_chunk_pallas(*a, interpret=True), p, t))


@pytest.mark.parametrize("case", sorted(CHUNK_SHAPES))
def test_bwd_ref_is_the_adjoint_of_the_pallas_kernel(case):
    """<(dy, dS), J v> = <Jᵀ (dy, dS), v>, one tangent v per input, so each
    of dx, da, dB, dC is held on its own."""
    x, a, B, C, dy, ds = chunk_inputs(CHUNK_SHAPES[case], seed=1)
    grads = ssd_chunk_bwd_ref(*_t(x, a, B, C, dy, ds))
    rng = np.random.default_rng(2)
    for k, (prim, g) in enumerate(zip((x, a, B, C), grads)):
        v = rng.normal(size=prim.shape).astype(np.float32)
        tangents = tuple(v if m == k else np.zeros_like(q)
                         for m, q in enumerate((x, a, B, C)))
        _, (ty, tst) = pallas_jvp((x, a, B, C), tangents)
        lhs = (np.sum(dy.astype(np.float64) * np.asarray(ty))
               + np.sum(ds.astype(np.float64) * np.asarray(tst)))
        terms = g.double().numpy() * v
        assert abs(lhs - terms.sum()) <= TOL * np.abs(terms).sum(), (
            case, "xaBC"[k], lhs, terms.sum())


@pytest.mark.parametrize("case", sorted(CHUNK_SHAPES) + ["zamba2_bc"])
def test_bwd_ref_matches_autograd_of_the_chunk(case):
    shape = CHUNK_SHAPES.get(case, (1, 1, 256, 8, 64, 64))
    scale = 1.0 if case in CHUNK_SHAPES else 64 ** -0.5
    x, a, B, C, dy, ds = _t(*chunk_inputs(shape, scale, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (x, a, B, C)]
    y, st = ssd_chunk_ref(*leaves)
    want = torch.autograd.grad((y, st), leaves, (dy, ds))
    for what, g, w in zip("xaBC", ssd_chunk_bwd_ref(x, a, B, C, dy, ds),
                          want):
        leaf_close(g, w, what=what)


jax_ssd_ref = jax.jit(jax_ssd.ssd_ref, static_argnames=("chunk",))


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_gradients_match_jax_vjp(chunk, init):
    """The card's composition (``ssd_chunked`` with the ``ssd_chunk``
    Function) on the CPU against ``jax.vjp`` of the JAX package's
    ``ssd_ref``: S = 72 pads the last chunk; ``final`` gets a cotangent
    too, and with ``initial_state`` so does the initial state."""
    b, s, h, p, n = 2, 72, 3, 8, 4
    rng = np.random.default_rng(4)

    def r(*sh):
        return rng.normal(size=sh).astype(np.float32)
    prims = [r(b, s, h, p) * 0.5, -np.abs(r(b, s, h)) * 0.1,
             r(b, s, n) * 0.5, r(b, s, n) * 0.5]
    if init:
        prims.append(r(b, h, p, n))
    dy, dfinal = r(b, s, h, p), r(b, h, p, n)

    def jfn(x, a, B, C, s0=None):
        return jax_ssd_ref(x, a, B, C, chunk=chunk, initial_state=s0)
    _, vjp = jax.vjp(jfn, *prims)
    want = vjp((dy, dfinal))
    leaves = [t.requires_grad_(True) for t in _t(*prims)]
    y, final = ssd_chunked(*leaves[:4], chunk,
                           leaves[4] if init else None, ssd_chunk)
    got = torch.autograd.grad((y, final), leaves, _t(dy, dfinal))
    for what, g, w in zip(("x", "a", "B", "C", "initial_state"), got, want):
        leaf_close(g, w, what=what)


def test_cpu_backward_launches_nothing_and_the_wrapper_refuses_cpu():
    x, a, B, C, dy, ds = _t(*chunk_inputs((1, 2, 16, 2, 16, 8)))
    before = (ssd_chunk_cuda.launches, ssd_chunk_bwd_cuda.launches)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, B, C)]
    y, st = ssd_chunk(*leaves)
    torch.autograd.grad((y, st), leaves, (dy, ds))
    xs = x.reshape(1, 32, 2, 16).requires_grad_(True)
    out, _ = ssd(xs, a.reshape(1, 32, 2), B.reshape(1, 32, 8),
                 C.reshape(1, 32, 8), chunk=16)
    out.sum().backward()
    assert xs.grad is not None
    assert (ssd_chunk_cuda.launches, ssd_chunk_bwd_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_bwd_cuda(x, a, B, C, dy, ds)


# ------------------------------------------------------- the launch plan

@pytest.mark.parametrize("l", [16, 48, 200, 256])
@pytest.mark.parametrize("h", [1, 3, 5, 9, 32, 64])
def test_bwd_plan_covers_every_tile_and_head_once(h, l):
    b, c = 2, 3
    pl = bwd_plan(b, c, l, h, 64, 64)
    blocks = [pl.block(k) for k in range(pl.blocks)]
    seen = sorted((bc, jt, hh) for bc, jt, heads in blocks for hh in heads)
    assert seen == [(bc, jt, hh) for bc in range(b * c)
                    for jt in range(-(-l // TILE)) for hh in range(h)]
    jts = [jt for _, jt, _ in blocks]   # heaviest (j-tile 0) first
    assert jts == sorted(jts)
    assert pl.groups == -(-h // BWD_HEAD_GROUP)
    sizes = [len(heads) for _, _, heads in blocks[:pl.groups]]
    assert all(s == pl.head_group for s in sizes[:-1])
    assert 1 <= sizes[-1] <= pl.head_group <= BWD_HEAD_GROUP


def test_bwd_plan_at_the_train_shapes():
    """zamba2 (h 64, n 64) and mamba2 (h 32, n 128) train steps: 8 / 4
    groups of 8 heads, so 512 / 256 blocks of one CTA an SM, and the
    workspace's dG partials (10 tiles a group) dominate it: half of what
    groups of 4 heads wrote."""
    z = bwd_plan(4, 4, 256, 64, 64, 64)
    m = bwd_plan(4, 4, 256, 32, 64, 128)
    assert (z.j_tiles, z.head_group, z.groups, z.blocks) == (4, 8, 8, 512)
    assert (m.head_group, m.groups, m.blocks) == (8, 4, 256)
    assert (z.ws_dg, z.ws_dbs, z.ws_dcum) == (16 * 8 * 10 * 64 * 64,
                                              16 * 8 * 256 * 64,
                                              16 * 64 * 4 * 256)
    assert z.ws_floats * 4 == 33_554_432        # bytes
    # BwdSmem<64, 64>: prefix sums of 8 heads, G^T of 4 tiles, the main
    # phase's scratch (dG^T of 4 tiles; for each warpgroup dy's halves, two
    # of 32 x 64 (K = p) and two of 8 groups x 288 (K = i), and its raw 32
    # rows of 64 + 4), the j-tile's dcum rows and row l - 1 of 8 heads, one
    # head's dw w, the warpgroups' dw halves, column sums, row sums and the
    # diagonal tile's column sums
    assert z.smem_bytes == 4 * (8 * 256 + 4 * 64 * 64 + 4 * 64 * 64
                                + 2 * (2 * 32 * 64 + 2 * 8 * 288)
                                + 2 * 32 * 68 + 8 * 64 + 8 + 64 + 2 * 64
                                + 2 * 2 * 4 * 32 + 2 * 64 + 64) == 231_968
    # mamba2's n 128: the set-up's B tile, two C tiles (rows padded by 4)
    # and the raw dS (rows padded by 8) fit in the main phase's scratch
    assert m.smem_bytes == z.smem_bytes
    assert (64 * 132 + 2 * 64 * 132 + 64 * 136
            < 4 * 64 * 64 + 2 * (2 * 32 * 64 + 2 * 8 * 288) + 2 * 32 * 68)


@pytest.mark.parametrize("p", P_DIMS)
@pytest.mark.parametrize("n", N_DIMS)
def test_bwd_shared_memory_fits_a_block(p, n):
    # an H100 block's 232,448 bytes, less the kernel's static 256 (the
    # prefix sums' warp totals)
    assert bwd_smem_bytes(p, n) + 256 <= 232448
    assert bwd_plan(1, 1, MAX_L, 4, p, n).smem_bytes == bwd_smem_bytes(p, n)
    # the scratch is the larger of the set-up's (B tile, two C tiles or
    # dS's two halves, raw dS) and the main phase's (dG^T, dy's halves, raw
    # dy)
    setup = 64 * (n + 4) + max(2 * 64 * (n + 4), 2 * p * n) + p * (n + 8)
    main = 4 * 64 * 64 + 2 * (2 * 32 * p + 2 * p // 8 * 288) + 2 * 32 * (p + 4)
    assert bwd_smem_bytes(p, n) // 4 - max(setup, main) == (
        8 * 256 + 4 * 64 * 64 + 8 * 64 + 8 + 64 + 2 * 64 + 512 + 2 * 64 + 64)


@pytest.mark.parametrize("l,h,p,n", [(256, 3, 32, 64), (256, 3, 64, 32),
                                     (257, 1, 64, 64), (0, 1, 64, 64),
                                     (64, 0, 64, 64)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(l, h, p, n):
    with pytest.raises(ValueError):
        bwd_plan(1, 1, l, h, p, n)


# -------------------------------------------------- the kernel's blocking

def emulate_bwd(xc, ac, Bc, Cc, dy, ds, mm=mm3):
    """``ssd_chunk_bwd_kernel``'s blocks as ``bwd_plan`` lays them out, each
    writing its partials into a workspace (NaN until written), then the two
    finishing kernels' sums in their order.  Per block (b*c, j-tile, group
    of 8 heads), transposed (rows j): Gᵀ = B_j C_iᵀ of every i-tile >= the
    j-tile, once; per head and i-tile, each warpgroup on its 32 columns i:
    Mᵀ = Gᵀ ∘ Lᵀ, dx_j += Mᵀ dy_i, dMᵀ = x_j dy_iᵀ, dGᵀ += dMᵀ ∘ Lᵀ in
    head order, dsegᵀ = dMᵀ ∘ Mᵀ (the two warpgroups' dx sums over their
    rows i meet at the head's end); then per head the state terms (x_j dS
    over two halves of n, B_j dSᵀ scaled by w, added to the head's dx) and
    the j-tile's dcum rows.  Every product of the main kernel goes through
    ``mm`` (3xTF32 by default, as the kernel's tensor-core products); the
    finishing dB / dC products are plain f32, as their FMA kernel."""
    b, c, l, h, p = xc.shape
    n = Bc.shape[-1]
    pl = bwd_plan(b, c, l, h, p, n)
    T, J = TILE, pl.j_tiles

    def flat(t, tail):        # (b*c, J*T, ...), rows past l zero
        t = t.reshape((b * c, l) + tail)
        return torch.nn.functional.pad(t, (0, 0) * len(tail) + (0, J * T - l))
    x, a, dyf = flat(xc, (h, p)), flat(ac, (h,)), flat(dy, (h, p))
    B, C = flat(Bc, (n,)), flat(Cc, (n,))
    dS = ds.reshape(b * c, h, p, n)
    nan = float("nan")
    ws_dg = torch.full((b * c, pl.groups, J * (J + 1) // 2, T, T), nan)
    ws_dbs = torch.full((b * c, pl.groups, l, n), nan)
    ws_dcum = torch.full((b * c, h, J, l), nan)
    dx = torch.full((b * c, J * T, h, p), nan)
    rows = torch.arange(T)
    halves = (slice(0, T // 2), slice(T // 2, T))       # the warpgroups' i
    n_halves = ((slice(0, n // 2), slice(n // 2, n)) if n >= 16
                else (slice(0, n),))
    for k in range(pl.blocks):
        bc, jt, heads = pl.block(k)
        g = heads.start // pl.head_group
        j0, js = jt * T, slice(jt * T, jt * T + T)
        valid = min(T, l - j0)
        cum = torch.cumsum(a[bc][:, list(heads)], 0).T        # (nh, J*T)
        Gt = {it: mm(B[bc, js], C[bc, it * T:it * T + T].T)
              for it in range(jt, J)}                         # rows j
        dGt, dxm, rec, lastv = {}, {}, {}, {}
        for q, hh in enumerate(heads):
            dxa, rs, dclc = [0, 0], 0, torch.zeros(T)
            for it in range(jt, J):
                i0, is_ = it * T, slice(it * T, it * T + T)
                keep = (rows[:, None] <= rows[None, :]) | (it > jt)  # j <= i
                d = cum[q, None, is_] - cum[q, js, None]            # (j, i)
                Lt = torch.where(keep, torch.exp(torch.where(keep, d, 0.)),
                                 0.)
                for s, half in enumerate(halves):
                    dyh = dyf[bc, is_, hh][half]
                    dMt = mm(x[bc, js, hh], dyh.T)
                    Mt = Gt[it][:, half] * Lt[:, half]
                    dxa[s] = dxa[s] + mm(Mt, dyh)
                    dg = dMt * Lt[:, half]
                    dGt[it, s] = dg if q == 0 else dGt[it, s] + dg
                    dseg = dMt * Mt
                    rs = rs + dseg.sum(1)
                    ii = i0 + half.start + torch.arange(T // 2)
                    cs = dseg.sum(0)
                    if it == jt:
                        dclc[half] = cs
                    else:
                        ok = (ii < l) & (ii != l - 1)
                        ws_dcum[bc, hh, jt, ii[ok]] = cs[ok]
                        if bool((ii == l - 1).any()):
                            lastv[q] = cs[ii == l - 1].sum()
            dxm[q] = dxa[0] + dxa[1]
            rec[q] = dclc - rs
        # the state terms, per head
        dbs = 0
        for q, hh in enumerate(heads):
            w = torch.exp(cum[q, l - 1] - cum[q, js])
            xs = [mm(x[bc, js, hh], dS[bc, hh][:, m]) for m in n_halves]
            dbs = dbs + w[:, None] * torch.cat(xs, 1)
            dwh = [(B[bc, js][:, m] * xq).sum(1)
                   for m, xq in zip(n_halves, xs)]
            dww = (dwh[0] + dwh[1] if len(dwh) == 2 else dwh[0]) * w
            last = dww.sum()
            dx[bc, js, hh] = dxm[q] + mm(B[bc, js], dS[bc, hh].T) * w[:, None]
            row = rec[q] - dww
            r = l - 1 - j0                       # row l - 1: + sum_j dw_j w_j
            if r < T:
                row[r] = (rec[q][r] + last) - dww[r]
            else:
                ws_dcum[bc, hh, jt, l - 1] = lastv[q] + last
            ws_dcum[bc, hh, jt, j0:j0 + valid] = row[:valid]
        ws_dbs[bc, g, j0:j0 + valid] = dbs[:valid]
        for it in range(jt, J):
            ws_dg[bc, g, it * (it + 1) // 2 + jt] = torch.cat(
                [dGt[it, 0], dGt[it, 1]], 1).T                 # rows i
    # ssd_chunk_bwd_bc_kernel and ssd_chunk_bwd_da_kernel
    dB, dC = torch.zeros(b * c, J * T, n), torch.zeros(b * c, J * T, n)
    for bc in range(b * c):
        for r in range(J):
            rs = slice(r * T, r * T + T)
            st = 0
            for g in range(pl.groups):
                st = st + torch.nn.functional.pad(
                    ws_dbs[bc, g], (0, 0, 0, J * T - l))[rs]
            dB[bc, rs] = st
            for jt in range(r + 1):
                dG = sum(ws_dg[bc, g, r * (r + 1) // 2 + jt]
                         for g in range(pl.groups))
                dC[bc, rs] += dG @ B[bc, jt * T:jt * T + T]
            for it in range(r, J):
                dG = sum(ws_dg[bc, g, it * (it + 1) // 2 + r]
                         for g in range(pl.groups))
                dB[bc, rs] += dG.T @ C[bc, it * T:it * T + T]
    tiles = torch.arange(l) // T
    dcum = torch.stack([torch.where(jt <= tiles, ws_dcum[:, :, jt], 0.)
                        for jt in range(J)]).sum(0)           # (bc, h, l)
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    return (dx[:, :l].reshape(xc.shape), da.transpose(1, 2).reshape(ac.shape),
            dB[:, :l].reshape(Bc.shape), dC[:, :l].reshape(Cc.shape))


# ((b, c, l, h, p, n), B/C scale): the reduced configs, tests/test_kernels.py's
# shape, ragged chunks and head groups (5 heads; 9 in groups of 5 and 4), and
# one (b, c) of zamba2's and mamba2's train shapes.
EMULATED = {"reduced": ((2, 2, 32, 8, 16, 16), 1.0),
            "jax_test": ((1, 4, 16, 2, 16, 8), 1.0),
            "ragged_200_h5": ((1, 2, 200, 5, 64, 64), 64 ** -0.5),
            "h9_n128": ((1, 1, 256, 9, 64, 128), 128 ** -0.5),
            "zamba2_bc": ((1, 1, 256, 64, 64, 64), 64 ** -0.5),
            "mamba2_bc": ((1, 1, 256, 32, 64, 128), 128 ** -0.5)}


def rel_errors(got, want):
    """Each gradient's largest error over its largest magnitude."""
    out = []
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        out.append(float((g.double() - w.double()).abs().max()
                         / w.double().abs().max()))
    return out


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_blocking_matches_bwd_ref(case):
    shape, scale = EMULATED[case]
    inputs = _t(*chunk_inputs(shape, scale, seed=6))
    want = ssd_chunk_bwd_ref(*inputs)
    for what, g, w in zip("xaBC", emulate_bwd(*inputs), want):
        assert bool(torch.isfinite(g).all()), what
        leaf_close(g, w, what=what)


@pytest.mark.parametrize("decay", [3.0, 30.0])
def test_emulated_blocking_under_strong_decay(decay):
    """Decays that underflow exp(cum_i - cum_j) far off the diagonal
    (a = -|N| * decay): the decay is taken from the difference, so nothing
    overflows and no NaN appears (a ragged chunk, l = 200)."""
    x, a, B, C, dy, ds = chunk_inputs((1, 2, 200, 3, 16, 16), 0.25, seed=7)
    inputs = _t(x, a * (decay / 0.1), B, C, dy, ds)
    want = ssd_chunk_bwd_ref(*inputs)
    for what, g, w in zip("xaBC", emulate_bwd(*inputs), want):
        assert bool(torch.isfinite(g).all()), what
        leaf_close(g, w, what=what)


def test_one_tf32_product_for_the_record():
    """The same blocking with one TF32 product in place of three (``mm1``)
    at one (b, c) of zamba2's train shape, beside 3xTF32: both errors are
    printed (run with -s).  3xTF32 lands at 2.7-6.6e-7 of each gradient's
    largest magnitude, one product at 2.6-3.7e-4: above the 1e-4
    tolerance, the measured ground for the split."""
    shape, scale = EMULATED["zamba2_bc"]
    inputs = _t(*chunk_inputs(shape, scale, seed=6))
    want = ssd_chunk_bwd_ref(*inputs)
    three = rel_errors(emulate_bwd(*inputs), want)
    one = rel_errors(emulate_bwd(*inputs, mm=mm1), want)
    print("dx da dB dC: 3xTF32", three, "one TF32 product", one)
    assert max(three) <= TOL < max(one)
