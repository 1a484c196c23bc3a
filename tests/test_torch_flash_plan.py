"""The host-side launch arithmetic of the CUDA flash-attention kernels
(``repro_torch.kernels.flash_attention.kernel.plan`` and ``kv_tiles``), on
the CPU: the variant chosen for each (dtype, head dim), the grid and the
shared memory of each plan, and, for every q tile, the KV tiles loaded and
the first one that needs the mask, against a brute-force causal mask.
The kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    HEAD_DIMS, SMEM_LIMIT, kv_tiles, plan)

DTYPES = (torch.bfloat16, torch.float32)


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
       hd=st.sampled_from(HEAD_DIMS))
def test_grid_covers_every_q_row_once(B, Sq, H, sms, dtype, hd):
    p = plan(dtype, hd, B, Sq, H, sms=sms)
    if p.variant == "wgmma":
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
    p = plan(dtype, hd, 1, Sq, 1)
    for q0 in range(0, Sq, p.block_q):
        got = kv_tiles(q0, p.block_q, p.block_kv, Sq, Skv, causal, q_offset)
        want = brute_force_tiles(q0, p.block_q, p.block_kv, Sq, Skv, causal,
                                 q_offset)
        assert got == want, (q0, got, want)


@pytest.mark.parametrize("shape,q_offset,causal", [
    ((1024, 1024), 0, True),      # qwen3 / zamba2 prefill
    ((256, 1024), 768, True),     # a chunk after 768 cached tokens
    ((128, 1601), 0, False),      # 1601 image tokens, no mask
    ((1000, 1000), 0, True)])     # ragged last q tile
def test_kv_tiles_on_the_main_path_shapes(shape, q_offset, causal):
    Sq, Skv = shape
    p = plan(torch.bfloat16, 128, 1, Sq, 1)
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
    assert flash_attention_cuda.variant_launches == before
    assert flash_attention_cuda.launches == total
    assert set(before) == {"wgmma", "mma_sync", "fma"}
