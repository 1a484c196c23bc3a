"""The port's SSM and hybrid families against the JAX package's, on the CPU:
the SSD plain versions (``ssd_chunk_ref`` also against ``ssd_chunk_pallas``
in interpret mode), the card's SSD composition (chunk function + recurrence
across chunks, with ``ssd_chunk_ref`` in the CUDA kernel's place),
``_causal_conv``, ``mamba_block``, ``forward``, ``decode_step`` and the
serving engine, for reduced ``mamba2-370m`` (ssm) and ``zamba2-1.2b``
(hybrid).

Inputs are drawn with numpy from a seed and given to both sides as the same
values.  Tolerances: SSD 1e-4 (tests/test_kernels.py); models in f32 at
atol = rtol = 1e-4, in bf16 at atol 0.15 / rtol 0.05 (tests/test_models.py),
as in tests/test_torch_models.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.ssd import kernel as jax_ssd_kernel
from repro.kernels.ssd import ref as jax_ssd
from repro.models import ssm as jssm
from repro.models import transformer as jt
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro_torch.configs import get_config as tt_config
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels.ssd import (ssd_chunk_ref, ssd_chunked,
                                     ssd_decode_ref, ssd_ref)
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Request, ServingEngine

SSM_ARCHS = ["mamba2-370m", "zamba2-1.2b"]
SSD_TOL = 1e-4
TOL = {jnp.float32: dict(atol=1e-4, rtol=1e-4),
       jnp.bfloat16: dict(atol=0.15, rtol=0.05)}
B, S = 2, 40                   # S > the reduced chunk (32), not a multiple

ssd_chunk_pallas = jax.jit(jax_ssd_kernel.ssd_chunk_pallas,
                           static_argnames=("interpret",))
jax_ssd_ref = jax.jit(jax_ssd.ssd_ref, static_argnames=("chunk",))
jax_ssd_decode_ref = jax.jit(jax_ssd.ssd_decode_ref)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return params_from_jax(np.asarray(a), "cpu")


def _ssd_inputs(rng, shape_x, shape_a, shape_bc, scale_bc=1.0):
    """The JAX test's inputs: x * 0.5, a = -|N| * 0.1, B and C * scale."""
    x = jnp.asarray(rng.normal(size=shape_x), jnp.float32) * 0.5
    a = -jnp.abs(jnp.asarray(rng.normal(size=shape_a), jnp.float32)) * 0.1
    Bm = jnp.asarray(rng.normal(size=shape_bc), jnp.float32) * scale_bc
    Cm = jnp.asarray(rng.normal(size=shape_bc), jnp.float32) * scale_bc
    return x, a, Bm, Cm


# ---------------------------------------------------------------- SSD


# (b, c, l, h, p, n): tests/test_kernels.py's shape, the reduced configs'
# shape, and a chunk that is not a multiple of the CUDA kernel's 64-row tile.
CHUNK_SHAPES = {"jax_test": (1, 4, 16, 2, 16, 8),
                "reduced": (2, 2, 32, 8, 16, 16),
                "ragged_48": (1, 2, 48, 3, 16, 16)}


@pytest.mark.parametrize("case", sorted(CHUNK_SHAPES))
def test_ssd_chunk_ref_matches_pallas_interpret(case):
    b, c, l, h, p, n = CHUNK_SHAPES[case]
    rng = np.random.default_rng(5)
    xj, aj, Bj, Cj = _ssd_inputs(rng, (b, c, l, h, p), (b, c, l, h),
                                 (b, c, l, n))
    y_want, st_want = ssd_chunk_pallas(xj, aj, Bj, Cj, interpret=True)
    y, st = ssd_chunk_ref(_t(xj), _t(aj), _t(Bj), _t(Cj))
    assert y.shape == (b, c, l, h, p) and st.shape == (b, c, h, p, n)
    assert y.dtype == st.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), _f32(y_want), atol=SSD_TOL)
    np.testing.assert_allclose(_f32(st), _f32(st_want), atol=SSD_TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_ref_matches_jax(chunk, init):
    b, s, h, p, n = 2, 72, 3, 8, 4           # 72 % chunk != 0 for 16 / 32
    rng = np.random.default_rng(4)
    xj, aj, Bj, Cj = _ssd_inputs(rng, (b, s, h, p), (b, s, h), (b, s, n), 0.5)
    s0 = (jnp.asarray(rng.normal(size=(b, h, p, n)), jnp.float32)
          if init else None)
    y_want, st_want = jax_ssd_ref(xj, aj, Bj, Cj, chunk=chunk,
                                  initial_state=s0)
    y, st = ssd_ref(_t(xj), _t(aj), _t(Bj), _t(Cj), chunk=chunk,
                    initial_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(_f32(y), _f32(y_want), atol=SSD_TOL)
    np.testing.assert_allclose(_f32(st), _f32(st_want), atol=SSD_TOL)


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_composition_matches_jax_ssd_ref(init):
    """The code the card runs around its kernel (padding, f32 casts,
    recurrence across chunks), with ssd_chunk_ref in the kernel's place, on
    bf16 activations like the model's, S % chunk != 0."""
    b, s, h, p, n, chunk = 2, 80, 4, 16, 16, 32
    rng = np.random.default_rng(8)
    xj, aj, Bj, Cj = _ssd_inputs(rng, (b, s, h, p), (b, s, h), (b, s, n), 0.5)
    xj, Bj, Cj = (t.astype(jnp.bfloat16) for t in (xj, Bj, Cj))
    s0 = (jnp.asarray(rng.normal(size=(b, h, p, n)), jnp.float32)
          if init else None)
    y_want, st_want = jax_ssd_ref(xj, aj, Bj, Cj, chunk=chunk,
                                  initial_state=s0)
    y, st = ssd_chunked(_t(xj), _t(aj), _t(Bj), _t(Cj), chunk,
                        None if s0 is None else _t(s0), ssd_chunk_ref)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, p)
    # bf16 output: one bf16 ulp of |y| on top of the f32 tolerance.
    np.testing.assert_allclose(_f32(y), _f32(y_want), atol=SSD_TOL,
                               rtol=2.0 ** -8)
    np.testing.assert_allclose(_f32(st), _f32(st_want), atol=SSD_TOL)


def test_ssd_decode_ref_matches_jax_and_the_chunked_form():
    b, s, h, p, n = 2, 20, 3, 8, 4
    rng = np.random.default_rng(9)
    xj, aj, Bj, Cj = _ssd_inputs(rng, (b, s, h, p), (b, s, h), (b, s, n), 0.5)
    s0 = jnp.asarray(rng.normal(size=(b, h, p, n)), jnp.float32)
    st_j, st_t, ys = s0, _t(s0), []
    for t in range(s):
        y_want, st_j = jax_ssd_decode_ref(xj[:, t], aj[:, t], Bj[:, t],
                                          Cj[:, t], st_j)
        y, st_t = ssd_decode_ref(_t(xj[:, t]), _t(aj[:, t]), _t(Bj[:, t]),
                                 _t(Cj[:, t]), st_t)
        np.testing.assert_allclose(_f32(y), _f32(y_want), atol=SSD_TOL)
        ys.append(y)
    np.testing.assert_allclose(_f32(st_t), _f32(st_j), atol=SSD_TOL)
    # the sequential recurrence is the chunked algorithm, state included
    y_chunk, st_chunk = ssd_ref(_t(xj), _t(aj), _t(Bj), _t(Cj), chunk=8,
                                initial_state=_t(s0))
    np.testing.assert_allclose(_f32(torch.stack(ys, 1)), _f32(y_chunk),
                               atol=SSD_TOL)
    np.testing.assert_allclose(_f32(st_t), _f32(st_chunk), atol=SSD_TOL)


# ---------------------------------------------------------------- models

def _perturb(tree, rng):
    """Norm weights, A_log, dt_bias and D drawn from numpy, so that they are
    not the init's zeros and ones."""
    out = dict(tree)
    for name, arr in tree.items():
        noise = rng.normal(size=arr.shape)
        if name.endswith("norm") or name == "D":
            out[name] = jnp.asarray(1.0 + 0.1 * noise, jnp.bfloat16)
        elif name in ("A_log", "dt_bias"):
            out[name] = jnp.asarray(0.5 * noise, jnp.bfloat16)
    return out


def _jax_params(arch, dtype):
    cfg = jax_reduced_config(arch)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    params = dict(params, blocks=_perturb(params["blocks"], rng))
    if "shared" in params:
        params["shared"] = _perturb(params["shared"], rng)
    return cfg, jax.tree.map(lambda a: a.astype(dtype), params)


def _both(arch, dtype):
    cfg, jp = _jax_params(arch, dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, reduced_config(arch), jp, tp


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _layer0(tree):
    return {k: v[0] for k, v in tree.items()}


@pytest.mark.parametrize("decode", [False, True])
def test_causal_conv_matches_jax(decode):
    rng = np.random.default_rng(12)
    W, ch, s = 4, 24, 1 if decode else 9
    xj = jnp.asarray(rng.normal(size=(B, s, ch)), jnp.float32)
    wj = jnp.asarray(rng.normal(size=(W, ch)), jnp.float32)
    cj = (jnp.asarray(rng.normal(size=(B, W - 1, ch)), jnp.bfloat16)
          if decode else None)
    want, want_state = jssm._causal_conv(xj, wj, cj)
    got, got_state = tssm._causal_conv(_t(xj), _t(wj),
                                       None if cj is None else _t(cj))
    assert got.shape == (B, s, ch)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5)
    np.testing.assert_allclose(_f32(got_state), _f32(want_state), atol=0)


@pytest.mark.parametrize("decode", [False, True])
def test_mamba_block_matches_jax(decode):
    jcfg, tcfg, jp, tp = _both("zamba2-1.2b", jnp.float32)
    rng = np.random.default_rng(13)
    s = 1 if decode else S
    xj = jnp.asarray(rng.normal(size=(B, s, jcfg.d_model)), jnp.float32)
    state_j = state_t = None
    if decode:
        d_in, nh, n, conv_ch = jssm.ssm_dims(jcfg)
        state_j = (jnp.asarray(rng.normal(size=(B, jcfg.conv_width - 1,
                                                conv_ch)), jnp.bfloat16),
                   jnp.asarray(rng.normal(size=(B, nh, jcfg.ssm_head_dim, n)),
                               jnp.float32))
        state_t = tuple(_t(a) for a in state_j)
    want, want_state = jax.jit(
        lambda x, lp, st: jssm.mamba_block(x, lp, jcfg, state=st))(
            xj, _layer0(jp["blocks"]), state_j)
    got, got_state = tssm.mamba_block(_t(xj), _layer0(tp["blocks"]), tcfg,
                                      state=state_t)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[jnp.float32])
    if decode:
        for g, w in zip(got_state, want_state):
            np.testing.assert_allclose(_f32(g), _f32(w), **TOL[jnp.float32])
    else:
        assert got_state is None and want_state is None


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg)
    want = jax.jit(lambda p, t: jt.forward(p, jcfg, t, remat="none")[0])(
        jp, jnp.asarray(toks))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks), remat="none")
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _compare_states(tstate, jstate, tol):
    for name in ("conv", "ssd", "shared_k", "shared_v"):
        if name in jstate:
            assert tstate[name].shape == jstate[name].shape, name
            np.testing.assert_allclose(_f32(tstate[name]), _f32(jstate[name]),
                                       err_msg=name, **tol)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_steps_match_jax(arch, dtype):
    """8 decode steps from an empty cache against JAX's decode_step run op
    by op (f32, 1e-4) and compiled (the bf16 tolerance), as
    tests/test_torch_models.py holds the dense family; the conv, ssd and
    shared-KV states are compared after the last step."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg, seed=1, shape=(B, 8))
    jstate = jt.init_decode_state(jcfg, B, 12)
    cstate = jt.init_decode_state(jcfg, B, 12)
    tstate = tt.init_decode_state(tcfg, B, 12, device="cpu")
    assert set(tstate) == set(jstate)
    compiled = jax.jit(lambda p, s, t: jt.decode_step(p, jcfg, s, t))
    for t in range(8):
        tok = jnp.asarray(toks[:, t:t + 1])
        want_c, cstate = compiled(jp, cstate, tok)
        if dtype == jnp.float32:
            with jax.disable_jit():
                want, jstate = jt.decode_step(jp, jcfg, jstate, tok)
        else:
            want, jstate = want_c, cstate
        got, tstate = tt.decode_step(tp, tcfg, tstate,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
        np.testing.assert_allclose(_f32(got), _f32(want_c),
                                   **TOL[jnp.bfloat16])
    assert tstate["pos"] == int(jstate["pos"]) == 8
    assert tstate["ssd"].dtype == torch.float32
    assert tstate["conv"].dtype == (torch.float32 if dtype == jnp.float32
                                    else torch.bfloat16)
    _compare_states(tstate, jstate, TOL[dtype])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_updates_the_state_tensors_in_place(arch):
    tcfg = reduced_config(arch)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    state = tt.init_decode_state(tcfg, B, 8, device="cpu")
    before = {k: v for k, v in state.items() if k != "pos"}
    _, new = tt.decode_step(tp, tcfg, state, torch.ones(B, 1,
                                                        dtype=torch.long))
    assert new["pos"] == 1 and state["pos"] == 0
    for name, t in before.items():
        assert new[name] is t, name
        assert bool((t != 0).any()), name


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode must reproduce the full-sequence logits
    (bf16 weights, tests/test_models.py's tolerance)."""
    tcfg = reduced_config(arch)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg))
    full, _ = tt.forward(tp, tcfg, toks, remat="none")
    state = tt.init_decode_state(tcfg, B, S + 4, device="cpu")
    outs = []
    for t in range(S):
        lg, state = tt.decode_step(tp, tcfg, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_f32(torch.stack(outs, 1)), _f32(full),
                               atol=0.15, rtol=0.05)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_full_depth_bf16_amplifies_last_bit_ssd_differences(arch, monkeypatch):
    """Why chip_smoke.py holds the full-width SSM prefill with kernels
    against the plain forward in f32, and reports the bf16 gap: at the
    published depth (38 / 48 layers, chunk 256, state 64 / 128, narrowed to
    d_model 256 to run here), random bf16 weights turn a last-bit change in
    the SSD chunk's f32 result (here: the same block computed in f64, as a
    kernel's other order of sums would change it) into logit differences of
    order 1, far past 0.15 / 0.05; with f32 weights the same change stays
    within ~1e-3.  No kernel is involved."""
    full = tt_config(arch)
    cfg = dataclasses.replace(
        full, d_model=256, vocab=512,
        **({"n_heads": 4, "n_kv_heads": 4, "head_dim": 64, "d_ff": 1024}
           if full.n_heads else {}))
    toks = torch.from_numpy(_tokens(cfg, shape=(1, 256)))

    def chunk_f64(*t):
        return tuple(o.float()
                     for o in ssd_chunk_ref(*(x.double() for x in t)))

    def f64_ssd(x, a, B, C, chunk, force_ref=False):
        return ssd_chunked(x, a, B, C, chunk, None, chunk_f64)
    for dtype, within in ((torch.bfloat16, False), (torch.float32, True)):
        params = {k: ({n: t.to(dtype) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(dtype))
                  for k, v in tt.init_params(
                      cfg, torch.Generator().manual_seed(0)).items()}
        want, _ = tt.forward(params, cfg, toks)
        with monkeypatch.context() as mp:
            mp.setattr(tssm, "ssd", f64_ssd)
            got, _ = tt.forward(params, cfg, toks)
        assert bool(torch.isfinite(got).all())
        close = np.allclose(_f32(got), _f32(want), atol=0.15, rtol=0.05)
        assert close == within, (dtype, float((got - want).abs().max()))


# ---------------------------------------------------------------- serving

ENGINE_TOL = 1e-3      # f32 weights over a bf16 shared-KV cache, as in
N_REQ, BATCH, MAX_SEQ, MAX_NEW = 6, 4, 16, 4   # tests/test_torch_serve.py


def _serve(eng, reqs, to_np):
    seen, inner = [], eng._decode

    def step(params, state, toks):
        logits, state = inner(params, state, toks)
        seen.append(to_np(logits[:, -1]))
        return logits, state
    eng._decode = step
    for r in reqs:
        eng.submit(r)
    return eng.run(), seen


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    """Same f32 weights and requests (no retrieval); the shared scalar pos
    runs past max_seq.  Every step's logits agree within ENGINE_TOL and each
    row's top-1 / top-2 margin exceeds it, so equal tokens are not luck."""
    jcfg, tcfg, jp, tp = _both(arch, jnp.float32)
    rng = np.random.default_rng(4)    # no top-2 near-tie on either model
    prompts = [rng.integers(0, jcfg.vocab, rng.integers(3, 9), dtype=np.int32)
               for _ in range(N_REQ)]
    jdone, jlog = _serve(
        JaxServingEngine(jp, jcfg, batch=BATCH, max_seq=MAX_SEQ),
        [JaxRequest(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)],
        lambda x: np.asarray(x, np.float32))
    tdone, tlog = _serve(
        ServingEngine(tp, tcfg, batch=BATCH, max_seq=MAX_SEQ, device="cpu"),
        [Request(i, p, max_new=MAX_NEW) for i, p in enumerate(prompts)],
        lambda x: x.float().numpy())
    assert len(tlog) == len(jlog) > MAX_SEQ
    for step, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=ENGINE_TOL, rtol=ENGINE_TOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(b, axis=-1)[:, -2:]
        assert ((top2[:, 1] - top2[:, 0]) > ENGINE_TOL).all(), step
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert len(tdone) == N_REQ
    assert all(len(r.output) == MAX_NEW for r in tdone)
