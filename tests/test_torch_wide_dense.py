"""The widest dense configs, qwen2.5-14b, mistral-large-123b and
llama3-405b, against the JAX package on the CPU, each at its own shape.

``reduced_config`` gives every model 4 query heads over at most 2 KV heads
and rope_theta 10000, so it drops what sets these three apart.  Here each
config is narrowed instead with ``dataclasses.replace`` on both packages'
configs (a few layers, narrow widths) keeping its GQA group (5, 12 or 16
query heads per KV head, over 2 KV heads), its rope_theta (1e6, 1e6, 5e5),
its qkv biases (qwen2.5-14b's, perturbed from numpy as
tests/test_torch_models.py perturbs them) and its untied head.  Weights are
JAX-initialised and cross over through ``params_from_jax``.

Tolerances, from tests/test_torch_models.py and tests/test_torch_train.py:
logits in f32 at atol = rtol = 1e-4, in bf16 at the JAX package's
prefill-vs-decode tolerance (atol 0.15, rtol 0.05), since bf16 rounds at
different places in the two frameworks; the f32 loss at 1e-5 and each f32
gradient leaf within 1e-4 of its largest magnitude.  With bf16 weights the
loss is held at the bf16 logits tolerance, and each gradient leaf against
the f32 gradient of the same weights (JAX's, on them cast to f32): its
relative L2 error at most FLOOR_FACTOR times the reference's own bf16
gradient's, the rule the card holds bf16 gradients to (PERF.md §2).  A
fixed bound would measure the reference's rounding as much as the port's:
qwen2.5-14b's bv lies 0.025 from f32 in JAX's bf16 run, 0.009 in the
port's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves, tree_unflatten

GROUPS = {"qwen2.5-14b": 5, "mistral-large-123b": 12, "llama3-405b": 16}
ARCHS = sorted(GROUPS)
KV_HEADS = 2
NARROW = dict(n_layers=2, d_model=64, n_kv_heads=KV_HEADS, head_dim=16,
              d_ff=128, vocab=256)
TOL = {jnp.float32: dict(atol=1e-4, rtol=1e-4),
       jnp.bfloat16: dict(atol=0.15, rtol=0.05)}
FLOOR_FACTOR = 2
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads (the test workers share the machine's cores);
    restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _narrow(cfg, arch):
    return dataclasses.replace(cfg, n_heads=GROUPS[arch] * KV_HEADS, **NARROW)


def _configs(arch):
    return (_narrow(jax_get_config(arch), arch),
            _narrow(get_config(arch), arch))


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """JAX init, norm weights and qkv biases perturbed from numpy (not all
    ones / zeros); JAX arrays, so the cached tree is never changed."""
    jcfg, _ = _configs(arch)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    blocks = dict(params["blocks"])
    for name in sorted(blocks):
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            base = 1.0 if name.endswith("norm") else 0.0
            blocks[name] = jnp.asarray(
                base + 0.1 * rng.normal(size=blocks[name].shape), jnp.bfloat16)
    return dict(params, blocks=blocks, final_norm=jnp.asarray(
        1.0 + 0.1 * rng.normal(size=params["final_norm"].shape),
        jnp.bfloat16))


def _both(arch, dtype):
    """``_jax_init``'s weights cast to ``dtype``, and the same weights in
    the port."""
    jcfg, tcfg = _configs(arch)
    jp = jax.tree.map(lambda a: a.astype(dtype), _jax_init(arch))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_narrowed_config_keeps_the_model_shape(arch):
    jcfg, tcfg = _configs(arch)
    full = get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.n_heads // tcfg.n_kv_heads == GROUPS[arch] \
        == full.n_heads // full.n_kv_heads
    assert (tcfg.rope_theta, tcfg.qkv_bias, tcfg.tie_embeddings,
            tcfg.family) == (full.rope_theta, full.qkv_bias,
                             full.tie_embeddings, "dense")
    assert not tcfg.tie_embeddings
    assert tcfg.qkv_bias == (arch == "qwen2.5-14b")
    head = dict(tree_leaves(tt.abstract_params(tcfg)))[("lm_head",)]
    assert tuple(head.shape) == (tcfg.d_model, tcfg.vocab)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg)
    want = jax.jit(lambda p, t: jt.forward(p, jcfg, t, remat="none")[0])(
        jp, jnp.asarray(toks))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks), remat="none")
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_steps_match_jax(arch, dtype):
    """8 decode steps from an empty cache.  f32 is held against JAX's
    decode_step run op by op (``jax.disable_jit``) and the compiled one at
    the bf16 tolerance: tests/test_torch_models.py says why (compiled, the
    reference drifts from its own op-by-op run with non-zero qkv biases)."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg, seed=1, shape=(B, 8))
    jstate = jt.init_decode_state(jcfg, B, 12)
    cstate = jt.init_decode_state(jcfg, B, 12)
    tstate = tt.init_decode_state(tcfg, B, 12, device="cpu")
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
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(got), _np(want_c),
                                   **TOL[jnp.bfloat16])
    assert tstate["pos"] == int(jstate["pos"]) == 8
    np.testing.assert_allclose(_np(tstate["k"]), _np(jstate["k"]),
                               **TOL[dtype])


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_loss_and_grads_match_jax(arch, dtype):
    """The dense loss and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's forward and ``lm_loss`` (bf16:
    beside the f32 gradient, as the module's docstring says)."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg, seed=2, shape=(4, S + 1))
    inputs, labels = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        logits, _ = jt.forward(p, jcfg, inputs, remat="none")
        return jt.lm_loss(logits, labels)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    paths, leaves = zip(*tree_leaves(tp))
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    logits, _ = tt.forward(tree_unflatten(zip(paths, req)), tcfg,
                           torch.from_numpy(inputs), remat="none")
    loss = tt.lm_loss(logits, torch.from_numpy(labels))
    grads = dict(zip(paths, torch.autograd.grad(loss, req)))
    loss = float(loss.detach())
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    assert sorted(jflat) == sorted(grads)
    if dtype == jnp.float32:
        np.testing.assert_allclose(loss, float(jl), atol=1e-5, rtol=1e-5)
        for path, g in grads.items():
            want = np.asarray(jflat[path], np.float32)
            err = float(np.abs(_np(g) - want).max())
            assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), (
                path, err)
    else:
        np.testing.assert_allclose(loss, float(jl), **TOL[jnp.bfloat16])
        assert all(g.dtype == torch.bfloat16 for g in grads.values())
        _, g32 = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(lambda a: a.astype(jnp.float32), jp))
        f32 = dict(tree_leaves(jax.tree.map(np.asarray, g32)))
        for path, g in grads.items():
            want = _np(f32[path])
            err, floor = _rel_l2(_np(g), want), _rel_l2(_np(jflat[path]), want)
            assert err <= FLOOR_FACTOR * floor, (path, err, floor)
