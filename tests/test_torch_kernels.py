"""The port's plain kernels (``repro_torch.kernels``) against the JAX
package's, on the CPU: RMSNorm and flash attention against the JAX oracles
and the Pallas kernels in interpret mode, decode attention, and the CPU
dispatch (plain path, no launches, no fallback from the CUDA wrappers).
The SSD plain versions are held against JAX in tests/test_torch_ssm.py.

Inputs are drawn with numpy from a seed and given to both sides as the same
values (bf16 inputs are rounded once, in JAX, and carried bit-exactly).
Tolerances are the JAX package's own (tests/test_kernels.py): RMSNorm 1e-5
f32 / 3e-2 bf16, flash attention 5e-5 f32 / 2e-2 bf16 against the oracle and
1e-4 against the Pallas kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jax_fa_kernel
from repro.kernels.flash_attention import ref as jax_fa
from repro.kernels.rmsnorm import kernel as jax_rms_kernel
from repro.kernels.rmsnorm import ref as jax_rms
from repro_torch.interop import params_from_jax
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.kernels.flash_attention import (decode_attention_ref,
                                                 flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.rmsnorm import (gated_rmsnorm_ref, rmsnorm_cuda,
                                         rmsnorm_ref)
from repro_torch.kernels.ssd import ssd, ssd_chunk_cuda, ssd_ref

# The JAX side runs jitted: one compile per shape instead of one per op.
jax_rmsnorm_ref = jax.jit(jax_rms.rmsnorm_ref)
jax_gated_rmsnorm_ref = jax.jit(jax_rms.gated_rmsnorm_ref)
rmsnorm_pallas = jax.jit(jax_rms_kernel.rmsnorm_pallas,
                         static_argnames=("interpret", "block_rows"))
jax_flash_attention_ref = jax.jit(
    jax_fa.flash_attention_ref,
    static_argnames=("causal", "q_offset", "block_kv"))
flash_attention_pallas = jax.jit(
    jax_fa_kernel.flash_attention_pallas,
    static_argnames=("causal", "q_offset", "block_q", "block_kv",
                     "interpret"))
jax_decode_attention_ref = jax.jit(jax_fa.decode_attention_ref)

RMS_TOL = {jnp.float32: 1e-5, jnp.bfloat16: 3e-2}
FLASH_TOL = {jnp.float32: 5e-5, jnp.bfloat16: 2e-2}
PALLAS_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a CPU torch tensor."""
    a = jnp.asarray(rng.normal(size=shape), dtype)
    return a, params_from_jax(np.asarray(a), "cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------------- rmsnorm

RMS_SHAPES = [(4, 64), (3, 17, 96), (2, 2, 2, 128),      # test_rmsnorm_sweep
              (5, 16), (6, 128), (3, 2048)]               # d in {16,128,2048}


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rmsnorm_ref_matches_jax(shape, dtype):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, shape, dtype)
    wj, wt = _pair(rng, shape[-1:], dtype)
    got = rmsnorm_ref(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_allclose(_f32(got), _f32(jax_rmsnorm_ref(xj, wj)),
                               atol=RMS_TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(rmsnorm_pallas(xj, wj, interpret=True, block_rows=8)),
        atol=RMS_TOL[dtype])


def test_gated_rmsnorm_ref_matches_jax():
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng, (4, 32), jnp.float32)
    gj, gt = _pair(rng, (4, 32), jnp.float32)
    wj, wt = _pair(rng, (32,), jnp.float32)
    np.testing.assert_allclose(_f32(gated_rmsnorm_ref(xt, gt, wt)),
                               _f32(jax_gated_rmsnorm_ref(xj, gj, wj)),
                               atol=1e-5)


# --------------------------------------------------------- flash attention

# (B, Sq, Skv, H, KV, hd, q_offset)
FLASH_CASES = {
    "mha": (1, 128, 128, 4, 4, 32, 0),
    "gqa4": (2, 256, 256, 8, 2, 64, 0),
    "mqa_192": (1, 192, 192, 6, 1, 64, 0),          # non-power-of-2 length
    "q_offset": (1, 64, 192, 4, 2, 32, 128),        # chunked prefill
    "ragged_kv": (1, 64, 100, 4, 2, 32, 36),        # Skv % block_kv != 0
}


def _qkv(case, dtype, seed=0):
    B, Sq, Skv, H, KV, hd, _ = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    return (_pair(rng, (B, Sq, H, hd), dtype),
            _pair(rng, (B, Skv, KV, hd), dtype),
            _pair(rng, (B, Skv, KV, hd), dtype))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_ref_matches_jax_ref(case, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, dtype)
    off = FLASH_CASES[case][-1]
    got = flash_attention_ref(qt, kt, vt, causal=causal, q_offset=off,
                              block_kv=64)
    want = jax_flash_attention_ref(qj, kj, vj, causal=causal, q_offset=off,
                                   block_kv=64)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_pallas_interpret(case, causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(case, jnp.float32, seed=1)
    off = FLASH_CASES[case][-1]
    got = flash_attention_ref(qt, kt, vt, causal=causal, q_offset=off)
    want = flash_attention_pallas(qj, kj, vj, causal=causal, q_offset=off,
                                  block_q=64, block_kv=64, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=PALLAS_TOL)


@pytest.mark.parametrize("kv_len", ["scalar", "per_row"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_attention_ref_matches_jax(kv_len, dtype):
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = 3, 40, 8, 2, 32
    qj, qt = _pair(rng, (B, 1, H, hd), dtype)
    kj, kt = _pair(rng, (B, S, KV, hd), dtype)
    vj, vt = _pair(rng, (B, S, KV, hd), dtype)
    if kv_len == "scalar":
        lj, lt = 23, 23
    else:
        lens = np.array([5, 40, 17], np.int32)
        lj, lt = jnp.asarray(lens), torch.from_numpy(lens)
    got = decode_attention_ref(qt, kt, vt, lt)
    want = jax_decode_attention_ref(qj, kj, vj, lj)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=FLASH_TOL[dtype])


# ------------------------------------------------------------ dispatch

def test_ops_on_cpu_take_the_plain_path_without_launching():
    rmsnorm_cuda.launches = 0
    flash_attention_cuda.launches = 0
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    assert torch.equal(rmsnorm(x, w), rmsnorm_ref(x, w))
    (_, q), (_, k), (_, v) = _qkv("gqa4", jnp.float32)
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))
    assert rmsnorm_cuda.launches == 0
    assert flash_attention_cuda.launches == 0


def test_ssd_on_cpu_takes_the_plain_path_without_launching():
    ssd_chunk_cuda.launches = 0
    rng = np.random.default_rng(8)
    x, B, C = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((2, 40, 3, 16), (2, 40, 16), (2, 40, 16)))
    a = -torch.from_numpy(rng.random((2, 40, 3)).astype(np.float32)) * 0.1
    y, st = ssd(x, a, B, C, chunk=32)
    y_ref, st_ref = ssd_ref(x, a, B, C, chunk=32)
    assert torch.equal(y, y_ref) and torch.equal(st, st_ref)
    assert ssd_chunk_cuda.launches == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: a CPU tensor is never computed there."""
    x = torch.ones(4, 64)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, torch.ones(64))
    q = torch.ones(1, 8, 2, 16)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    xc, ac = torch.ones(1, 2, 16, 2, 16), torch.ones(1, 2, 16, 2)
    with pytest.raises(ValueError):
        ssd_chunk_cuda(xc, ac, torch.ones(1, 2, 16, 8), torch.ones(1, 2, 16, 8))
    assert rmsnorm_cuda.launches == 0
    assert flash_attention_cuda.launches == 0
    assert ssd_chunk_cuda.launches == 0
