"""The host-side launch arithmetic of the CUDA flash-attention kernels
(``repro_torch.kernels.flash_attention.kernel.plan``, ``kv_tiles`` and the
decode variant's ``decode_splits``, and the backward's ``bwd_plan``,
``bwd_items``, ``bwd_q_blocks`` and ``bwd_tile_masked``), on the CPU: the
variant chosen for each (dtype, head dim, Sq), the grid and the shared
memory of each plan, the persistent schedules, and, for every q tile (key
block), the KV tiles (q blocks) visited and where the mask is needed,
against a brute-force causal mask; the decode variant's key splits, and
their partials merged as its kernel merges them against the JAX package's
Pallas kernel in interpret mode.  The kernels themselves run only on the
card (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels.flash_attention import kernel as jax_fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    DECODE_FILL, DECODE_SPLITS, HEAD_DIMS, SMEM_LIMIT, bwd_items, bwd_plan,
    bwd_q_blocks, bwd_tile_masked, decode_keys, decode_splits, kv_tiles, plan)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    decode_attention_block, flash_attention_ref)

DTYPES = (torch.bfloat16, torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dtype,hd,variant", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 16, "mma_sync"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 32, "fma"), (torch.float32, 16, "fma")])
def test_variant_for_dtype_and_head_dim(dtype, hd, variant):
    assert plan(dtype, hd, 4, 1024, 16).variant == variant


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_every_plan_fits_shared_memory(dtype, hd):
    p = plan(dtype, hd, 4, 1024, 16)
    assert 0 < p.smem_bytes <= SMEM_LIMIT
    assert p.threads % 128 == 0 if p.variant == "wgmma" else p.threads % 32 == 0


def test_wgmma_plan_matches_the_kernels_layout():
    """Two Q tiles, 2 ring slots of K and V (4 at hd 64), barriers, alignment
    slack: the byte counts of ``WgSmem`` in csrc/flash_attention.cu."""
    p128 = plan(torch.bfloat16, 128, 4, 1024, 16)
    assert (p128.block_q, p128.block_kv, p128.stages) == (128, 128, 2)
    assert p128.smem_bytes == 2 * 128 * 256 + 4 * 128 * 256 + 10 * 8 + 1024
    p64 = plan(torch.bfloat16, 64, 4, 1024, 32)
    assert (p64.block_q, p64.block_kv, p64.stages) == (128, 128, 4)
    assert p64.smem_bytes == 2 * 128 * 128 + 8 * 128 * 128 + 16 * 8 + 1024
    # Persistent: one CTA per SM, or one per work item if there are fewer.
    assert p128.grid == (132, 1, 1) and p64.grid == (132, 1, 1)
    assert plan(torch.bfloat16, 128, 1, 100, 2, sms=132).grid == (2, 1, 1)


@pytest.mark.parametrize("bad", [(torch.bfloat16, 96), (torch.float16, 64),
                                 (torch.float32, 256)])
def test_plan_refuses_what_no_kernel_takes(bad):
    with pytest.raises((ValueError, TypeError)):
        plan(bad[0], bad[1], 1, 8, 1)


def wgmma_items(p, B, Sq, H):
    """The (q0, h, b) work items each CTA of a persistent wgmma grid takes,
    as ``wg_item`` in csrc/flash_attention.cu walks them."""
    n_qt = -(-Sq // p.block_q)
    n_items = n_qt * H * B
    return [[((n_qt - 1 - w // (H * B)) * p.block_q, w % H, w // H % B)
             for w in range(cta, n_items, p.grid[0])]
            for cta in range(p.grid[0])]


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 8), Sq=st.integers(1, 5000), H=st.integers(1, 64),
       sms=st.integers(1, 140), dtype=st.sampled_from(DTYPES),
       hd=st.sampled_from(HEAD_DIMS), Skv=st.integers(1, 5000))
def test_grid_covers_every_q_row_once(B, Sq, H, sms, dtype, hd, Skv):
    p = plan(dtype, hd, B, Sq, H, sms=sms, Skv=Skv, KV=1)
    if p.variant == "decode":          # (key splits, KV x row tiles, B)
        splits, pairs, batch = p.grid
        tiles = -(-H // p.block_q)
        assert (Sq, pairs, batch) == (1, tiles, B)
        assert sorted(h for rt in range(tiles) for h in range(
            rt * p.block_q, min(H, (rt + 1) * p.block_q))) == list(range(H))
        assert 1 <= splits <= min(16, -(-Skv // p.block_kv))
    elif p.variant == "wgmma":
        per_cta = wgmma_items(p, B, Sq, H)
        items = [it for cta in per_cta for it in cta]
        assert p.grid[0] <= sms and all(per_cta)
        assert sorted(items) == sorted(
            (q0, h, b) for q0 in range(0, Sq, p.block_q)
            for h in range(H) for b in range(B))
        # Heaviest first: each CTA's q tiles come in falling order.
        assert all([it[0] for it in cta] == sorted((it[0] for it in cta),
                                                   reverse=True)
                   for cta in per_cta)
    else:                              # (q tiles, H, B)
        tiles, heads, batch = p.grid
        assert (heads, batch) == (H, B)
        assert (tiles - 1) * p.block_q < Sq <= tiles * p.block_q


def brute_force_tiles(q0, block_q, block_kv, Sq, Skv, causal, q_offset):
    """(tiles with a kept (q, k) pair, first loaded tile with a dropped one)
    from the whole mask of the q tile's valid rows over the padded keys."""
    rows = np.arange(q0, min(q0 + block_q, Sq))[:, None] + q_offset
    n_pad = -(-Skv // block_kv) * block_kv + block_kv
    keys = np.arange(n_pad)[None, :]
    keep = np.broadcast_to(keys < Skv, (len(rows), n_pad))
    if causal:
        keep = keep & (keys <= rows)
    kept = keep.reshape(len(rows), -1, block_kv)
    any_kept = kept.any(axis=(0, 2))
    n_tiles = int(np.nonzero(any_kept)[0].max()) + 1
    dropped = ~kept.all(axis=(0, 2))
    first = next((t for t in range(n_tiles) if dropped[t]), n_tiles)
    return n_tiles, first


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 700), Skv=st.integers(1, 900),
       q_offset=st.integers(0, 400), causal=st.booleans(),
       dtype=st.sampled_from(DTYPES), hd=st.sampled_from(HEAD_DIMS))
def test_kv_tiles_match_a_brute_force_mask(Sq, Skv, q_offset, causal, dtype,
                                           hd):
    p = plan(dtype, hd, 1, Sq, 1, Skv=Skv, KV=1, causal=causal,
             q_offset=q_offset)
    for q0 in range(0, Sq, p.block_q):
        got = kv_tiles(q0, p.block_q, p.block_kv, Sq, Skv, causal, q_offset)
        want = brute_force_tiles(q0, p.block_q, p.block_kv, Sq, Skv, causal,
                                 q_offset)
        assert got == want, (q0, got, want)


@pytest.mark.parametrize("shape,q_offset,causal", [
    ((1024, 1024), 0, True),      # qwen3 / zamba2 prefill
    ((256, 1024), 768, True),     # a chunk after 768 cached tokens
    ((128, 1601), 0, False),      # 1601 image tokens, no mask
    ((1024, 1601), 0, False),     # llama-vision's cross-attention prefill
    ((1, 1601), 0, False),        # ... and its decode step (Sq = 1)
    ((1000, 1000), 0, True)])     # ragged last q tile
def test_kv_tiles_on_the_main_path_shapes(shape, q_offset, causal):
    Sq, Skv = shape
    p = plan(torch.bfloat16, 128, 1, Sq, 1, Skv=Skv, KV=1, causal=causal,
             q_offset=q_offset)
    loaded = 0
    for q0 in range(0, Sq, p.block_q):
        n, first = kv_tiles(q0, p.block_q, p.block_kv, Sq, Skv, causal,
                            q_offset)
        assert (n, first) == brute_force_tiles(q0, p.block_q, p.block_kv, Sq,
                                               Skv, causal, q_offset)
        loaded += n
    full = -(-Sq // p.block_q) * -(-Skv // p.block_kv)
    # Causal prefill loads a little more than half of the tiles.
    assert loaded <= full and (not causal or q_offset or loaded < 0.6 * full)


def largest_power_of_two(n: int) -> int:
    return 1 << (n.bit_length() - 1)


def test_single_row_plan_for_decode_cross_attention():
    """One query row takes the ``decode`` variant (bf16, hd 64 / 128, causal
    or not; Sq >= 2 keeps ``wgmma``, hd 16 / 32 ``mma_sync`` and f32 ``fma``
    at any Sq).  Decode's cross-attention (llama-3.2-vision-90b: q (4, 1,
    64, 128) over 1601 image tokens in 8 KV heads) runs 8 key splits (a
    cluster) for each of its 32 (b, KV head) pairs, 256 CTAs; a 2 x 2
    rank's shard (2, 1, 32, 128) over 4 KV heads takes 16 (128 CTAs).  For
    every key count every key lies in exactly one non-empty split, and the
    grid fills a wave of SMs wherever the keys and the cluster (a power of
    two, at most 16 splits of at least 16 keys) allow."""
    bf16 = torch.bfloat16
    for hd in (64, 128):
        for causal in (False, True):
            p = plan(bf16, hd, 4, 1, 64, Skv=1601, KV=8, causal=causal,
                     q_offset=5000)
            assert (p.variant, p.block_q, p.block_kv, p.stages,
                    p.threads) == ("decode", 16, 16, 2, 128)
            assert p.smem_bytes == (
                max(4 * 2 * 2 * 16 * (hd + 8) * 2,
                    4 * 16 * (hd + 8) * 4 + 16 * hd * 4)
                + 2 * 4 * 16 * 4 + 2 * 16 * 4)
            assert p.smem_bytes <= SMEM_LIMIT
        assert plan(bf16, hd, 4, 2, 64, Skv=1601, KV=8).variant == "wgmma"
        assert plan(bf16, hd, 4, 1024, 64).variant == "wgmma"
        assert plan(bf16, hd, 4, 1, 64, Skv=1601, KV=8,
                    variant="wgmma").variant == "wgmma"
    assert plan(bf16, 128, 4, 1, 64, Skv=1601, KV=8).smem_bytes == 70272
    assert plan(bf16, 64, 4, 1, 64, Skv=1601, KV=8).smem_bytes == 37504
    for hd in (16, 32):
        assert plan(bf16, hd, 4, 1, 16, Skv=1601, KV=8).variant == "mma_sync"
    for hd in HEAD_DIMS:
        assert plan(torch.float32, hd, 4, 1, 16, Skv=1601,
                    KV=8).variant == "fma"
    with pytest.raises(ValueError):
        plan(bf16, 128, 4, 1, 64)                  # no keys to split
    with pytest.raises(ValueError):
        plan(bf16, 128, 4, 8, 64, Skv=1601, KV=8, variant="decode")

    full = plan(bf16, 128, 4, 1, 64, sms=132, Skv=1601, KV=8)
    assert full.grid == (8, 8, 4)
    assert [b - a for a, b in decode_splits(full, 1601, False, 0)] == [
        192, 208, 192, 208, 208, 192, 208, 193]
    shard = plan(bf16, 128, 2, 1, 32, sms=132, Skv=1601, KV=4)
    assert shard.grid == (16, 4, 2)
    assert decode_splits(shard, 1601, False, 0)[-1] == (1504, 1601)

    for Skv in (1, 65, 128, 129, 1601, 4096):
        for causal, q_offset in ((False, 0), (True, 0), (True, 64),
                                 (True, 700), (True, 5000)):
            for B, H, KV in ((4, 64, 8), (2, 32, 4), (1, 16, 1), (1, 1, 1)):
                p = plan(bf16, 128, B, 1, H, sms=132, Skv=Skv, KV=KV,
                         causal=causal, q_offset=q_offset)
                n_keys = min(Skv, q_offset + 1) if causal else Skv
                splits = decode_splits(p, Skv, causal, q_offset)
                keys = [key for a, b in splits for key in range(a, b)]
                assert keys == list(range(n_keys))
                assert all(a < b for a, b in splits)
                ctas = p.grid[0] * p.grid[1] * p.grid[2]
                most = largest_power_of_two(min(16, -(-n_keys // 16)))
                assert ctas >= min(132, B * KV * most), (Skv, causal,
                                                         q_offset, B, H, KV)


@settings(max_examples=60, deadline=None)
@given(B=st.integers(1, 8), Skv=st.integers(1, 40000), KV=st.integers(1, 8),
       group=st.integers(1, 40), causal=st.booleans(),
       q_offset=st.integers(0, 5000), sms=st.integers(1, 140),
       hd=st.sampled_from((64, 128)))
def test_decode_splits_cover_every_key_once(B, Skv, KV, group, causal,
                                            q_offset, sms, hd):
    """A power of two of splits, at most ``DECODE_SPLITS``, cut at 16-key
    chunks as evenly as they go (sizes a chunk apart at most, the last
    chunk ragged), none empty, over exactly the keys the mask keeps; a
    full wave of SMs wherever the keys and the cluster allow, and no more
    than ``DECODE_FILL`` CTAs an SM unless each (b, KV head, row tile)
    takes one."""
    H = KV * group
    p = plan(torch.bfloat16, hd, B, 1, H, sms=sms, Skv=Skv, KV=KV,
             causal=causal, q_offset=q_offset)
    n_keys = decode_keys(Skv, causal, q_offset)
    chunks = -(-n_keys // 16)
    splits = decode_splits(p, Skv, causal, q_offset)
    n = len(splits)
    assert n == largest_power_of_two(n) <= min(DECODE_SPLITS, chunks)
    assert splits[0][0] == 0 and splits[-1][1] == n_keys
    assert all(a < b and a % 16 == 0 for a, b in splits)
    assert all(b0 == a1 for (_, b0), (a1, _) in zip(splits, splits[1:]))
    sizes = [-(-(b - a) // 16) for a, b in splits]
    assert max(sizes) - min(sizes) <= 1
    tiles = -(-group // 16)
    pairs = B * KV * tiles
    assert p.grid == (n, KV * tiles, B)
    most = largest_power_of_two(min(DECODE_SPLITS, chunks))
    assert n * pairs >= min(sms, pairs * most)
    assert n * pairs <= max(DECODE_FILL * sms, pairs)


# The JAX package's flash kernel, jitted (one compile a shape), run in
# interpret mode: at Sq = 1 its block_q is 1, as decode's cross-attention
# runs it.
flash_attention_pallas = jax.jit(
    jax_fa_kernel.flash_attention_pallas,
    static_argnames=("causal", "q_offset", "block_q", "block_kv",
                     "interpret"))


@pytest.mark.parametrize("group,hd,Skv,causal,q_offset,sms", [
    (1, 64, 300, False, 0, 132), (1, 128, 300, False, 0, 132),
    (8, 64, 300, False, 0, 132), (8, 128, 300, False, 0, 132),
    (16, 64, 300, False, 0, 132), (16, 128, 300, False, 0, 132),
    (8, 128, 300, False, 0, 8),        # 4 splits (16 at 132 SMs)
    (16, 64, 300, True, 170, 8)])      # the causal row sees 171 keys
def test_decode_split_merge_matches_the_pallas_kernel(group, hd, Skv, causal,
                                                      q_offset, sms):
    """The decode variant's arithmetic in plain torch, f32: each split of
    ``plan()`` gives ``decode_attention_block``'s partial (o unnormalised, m,
    l), and the partials merge with weights exp(m_i - max), o = sum(w o) /
    sum(w l) and lse = max + log(sum(w l)), as the kernel's last CTA merges
    them; held against the JAX package's Pallas kernel (interpret mode) at
    the reference's 5e-5, and its lse against the plain version's."""
    B, KV = 2, 2
    H = KV * group
    rng = np.random.default_rng(group * 1000 + hd + Skv + q_offset)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, 1, H, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    p = plan(torch.bfloat16, hd, B, 1, H, sms=sms, Skv=Skv, KV=KV,
             causal=causal, q_offset=q_offset)
    splits = decode_splits(p, Skv, causal, q_offset)
    assert p.variant == "decode" and len(splits) > 1
    assert (splits[-1][1] - splits[-1][0]) % 16            # a ragged chunk
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    n_keys = decode_keys(Skv, causal, q_offset)
    parts = [decode_attention_block(tq, tk[:, a:b], tv[:, a:b], n_keys, a)
             for a, b in splits]
    m = torch.stack([pm for _, pm, _ in parts])            # (splits, B, H)
    top = m.amax(0)
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - top))
    den = (w * torch.stack([pl for _, _, pl in parts])).sum(0)
    num = sum(wi.reshape(B, 1, H, 1) * po for wi, (po, _, _) in zip(w, parts))
    got = num / den.reshape(B, 1, H, 1)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  q_offset=q_offset, block_q=1, block_kv=128,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    _, lse = flash_attention_ref(tq, tk, tv, causal=causal,
                                 q_offset=q_offset, return_lse=True)
    np.testing.assert_allclose((top + torch.log(den)).numpy(),
                               lse[..., 0].numpy(), atol=5e-5)


def test_cpu_path_counts_no_variant_launch():
    """The dispatch on a CPU tensor takes the plain version: neither the
    total nor any variant's launch count moves."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    before = dict(flash_attention_cuda.variant_launches)
    total = flash_attention_cuda.launches
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 64, generator=g, dtype=torch.float32)
    k = torch.randn(1, 8, 1, 64, generator=g, dtype=torch.float32)
    out = flash_attention(q, k, k, causal=True)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    # decode's shape (one bf16 row over the keys) on the CPU: plain too
    q1 = q[:, :1].to(torch.bfloat16)
    k1 = k.to(torch.bfloat16)
    out1 = flash_attention(q1, k1, k1, causal=False)
    assert out1.shape == q1.shape and bool(torch.isfinite(out1).all())
    assert flash_attention_cuda.variant_launches == before
    assert flash_attention_cuda.launches == total
    assert set(before) == {"wgmma", "mma_sync", "fma", "decode"}


# ------------------------------------------------------------------ backward

@pytest.mark.parametrize("dtype,hd,variant", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma_sync"), (torch.bfloat16, 16, "mma_sync"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 32, "fma"), (torch.float32, 16, "fma")])
def test_bwd_variant_for_dtype_and_head_dim(dtype, hd, variant):
    p = bwd_plan(dtype, hd, 4, 1024, 8)
    assert p.variant == variant
    assert 0 < p.smem_bytes <= SMEM_LIMIT


def test_bwd_wgmma_plan_matches_the_kernels_layout():
    """K and V tiles (128 keys; two of each at hd 64), `stages` slots of Q
    and dO (64 rows), two dS buffers and a P buffer (at hd 128 a second
    one, P's rounding remainder), two f32 dQ tiles, lse and D, barriers,
    alignment slack: the byte counts of ``BwdWgSmem`` in
    csrc/flash_attention.cu."""
    for hd, stages, kv_bufs in ((128, 2, 1), (64, 4, 2)):
        p = bwd_plan(torch.bfloat16, hd, 4, 1024, 8)
        assert (p.block_q, p.block_kv, p.stages, p.threads) == (
            64, 128, stages, 384)
        assert p.smem_bytes == (2 * kv_bufs * 128 * hd * 2
                                + 2 * stages * 64 * hd * 2
                                + (4 if hd == 128 else 3) * 64 * 128 * 2
                                + 2 * 64 * 64 * 4
                                + 2 * stages * 64 * 4
                                + (2 * stages + 2 * kv_bufs) * 8 + 1024)
    assert bwd_plan(torch.bfloat16, 128, 4, 1024, 8).smem_bytes == 231472
    assert bwd_plan(torch.bfloat16, 64, 4, 1024, 8).smem_bytes == 216160
    # Persistent: one CTA per SM, or one per item if there are fewer.
    assert bwd_plan(torch.bfloat16, 128, 4, 1024, 8).grid == (132, 1, 1)
    assert bwd_plan(torch.bfloat16, 64, 1, 200, 2, sms=132).grid == (4, 1, 1)


@settings(max_examples=40, deadline=None)
@given(B=st.integers(1, 6), Skv=st.integers(1, 3000), KV=st.integers(1, 16),
       sms=st.integers(1, 140), hd=st.sampled_from((64, 128)))
def test_bwd_schedule_visits_every_key_block_once_heaviest_first(B, Skv, KV,
                                                                 sms, hd):
    p = bwd_plan(torch.bfloat16, hd, B, Skv, KV, sms=sms)
    per_cta = bwd_items(p, B, Skv, KV)
    items = [it for cta in per_cta for it in cta]
    assert p.grid[0] <= sms and all(per_cta)
    assert sorted(items) == sorted(
        (k0, kvh, b) for k0 in range(0, Skv, 128) for kvh in range(KV)
        for b in range(B))
    # Heaviest (earliest) key block first within each CTA.
    assert all([it[0] for it in cta] == sorted(it[0] for it in cta)
               for cta in per_cta)


def test_bwd_schedule_balances_the_causal_triangle():
    """qwen3's training shape: 256 items on 132 CTAs.  The snake order pairs
    heavy and light key blocks, so no CTA visits more than 1.1x the mean of
    q blocks (in block order, CTA 0 would take key blocks 0 and 4: 1.375x)."""
    B, S, KV, group = 4, 1024, 8, 2
    p = bwd_plan(torch.bfloat16, 128, B, S, KV)
    work = [sum(group * len(bwd_q_blocks(k0, p.block_q, S, True, 0))
                for k0, _, _ in cta) for cta in bwd_items(p, B, S, KV)]
    assert sum(work) == group * KV * B * sum(
        len(bwd_q_blocks(k0, 64, S, True, 0)) for k0 in range(0, S, 128))
    assert max(work) <= 1.1 * sum(work) / len(work)


def brute_force_q_blocks(k0, block_kv, block_q, Sq, Skv, causal, q_offset):
    """q blocks holding a (q row < Sq, key < Skv) pair that the mask keeps,
    for the keys of the block from ``k0``."""
    keys = np.arange(k0, min(k0 + block_kv, Skv))[None, :]
    rows = np.arange(Sq)[:, None]
    keep = np.ones((Sq, keys.shape[1]), bool)
    if causal:
        keep = keys <= rows + q_offset
    return sorted({int(r) // block_q for r in np.nonzero(keep.any(1))[0]})


@settings(max_examples=60, deadline=None)
@given(Sq=st.integers(1, 700), Skv=st.integers(1, 900),
       q_offset=st.integers(0, 400), causal=st.booleans())
def test_bwd_q_blocks_match_a_brute_force_mask(Sq, Skv, q_offset, causal):
    p = bwd_plan(torch.bfloat16, 128, 1, Skv, 1)
    for k0 in range(0, Skv, p.block_kv):
        got = list(bwd_q_blocks(k0, p.block_q, Sq, causal, q_offset))
        assert got == brute_force_q_blocks(k0, p.block_kv, p.block_q, Sq, Skv,
                                           causal, q_offset), k0
        # Each consumer's 64 keys: masked whenever the tile drops a pair of
        # a q row below Sq and one of its keys.
        for kw0 in (k0, k0 + 64):
            keys = np.arange(kw0, kw0 + 64)[None, :]
            for qb in got:
                rows = np.arange(qb * 64, min(qb * 64 + 64, Sq))[:, None]
                keep = keys < Skv
                if causal:
                    keep = keep & (keys <= rows + q_offset)
                if not keep.all():
                    assert bwd_tile_masked(kw0, qb * 64, Skv, causal,
                                           q_offset), (kw0, qb)
