"""The port's dense model (``repro_torch.models``) against the JAX package's
on the CPU, on the same weights: JAX-initialised reduced configs cross over
through ``params_from_jax``.

Tolerances: f32 weights at atol = rtol = 1e-4 (f32 rounding: the two
frameworks sum the same products in different orders); bf16 weights at the
JAX package's own prefill-vs-decode tolerance, atol 0.15 / rtol 0.05
(tests/test_models.py), since bf16 rounds at different places in the two.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JAX_CONFIGS
from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as jt
from repro_torch.configs import CONFIGS, get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves

DENSE_ARCHS = ["qwen3-1.7b",      # qk_norm, tied embeddings
               "qwen2.5-14b",     # qkv_bias
               "llama3-405b"]     # neither, untied head
ALL_PORTED = sorted(a for a, c in CONFIGS.items()
                    if c.family in tt.FAMILIES)
TOL = {jnp.float32: dict(atol=1e-4, rtol=1e-4),
       jnp.bfloat16: dict(atol=0.15, rtol=0.05)}
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_params(arch, dtype):
    """JAX init, with norm weights and biases perturbed from numpy so that
    they are not all ones / zeros, cast to ``dtype``."""
    cfg = jax_reduced_config(arch)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    blocks = dict(params["blocks"])
    for name in blocks:
        if name.endswith("norm") or name in ("bq", "bk", "bv"):
            base = 1.0 if name.endswith("norm") else 0.0
            blocks[name] = jnp.asarray(
                base + 0.1 * rng.normal(size=blocks[name].shape), jnp.bfloat16)
    params = dict(params, blocks=blocks)
    return cfg, jax.tree.map(lambda a: a.astype(dtype), params)


def _both(arch, dtype):
    cfg, jp = _jax_params(arch, dtype)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, reduced_config(arch), jp, tp


def _tokens(cfg, seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _jax_forward(cfg):
    return jax.jit(lambda p, t: jt.forward(p, cfg, t, remat="none")[0])


def _jax_decode(cfg):
    return jax.jit(lambda p, s, t: jt.decode_step(p, cfg, s, t))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg)
    want = _jax_forward(jcfg)(jp, jnp.asarray(toks))
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks), remat="none")
    assert got.shape == (B, S, tcfg.vocab) and float(aux) == 0.0
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_steps_match_jax(arch, dtype):
    """8 decode steps from an empty cache, token by token, against JAX's
    decode_step run op by op (``jax.disable_jit``).  Compiled by XLA, the
    reference drifts from its own op-by-op run on qwen2.5-14b with non-zero
    qkv biases (up to 0.0086 in f32 logits from step 2; ROADMAP Queue 3), so
    the compiled run is held to the bf16 tolerance only — which is all the
    bf16 case asks, so it skips the (slow) op-by-op run."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = _tokens(jcfg, seed=1, shape=(B, 8))
    jstate = jt.init_decode_state(jcfg, B, 12)
    cstate = jt.init_decode_state(jcfg, B, 12)
    tstate = tt.init_decode_state(tcfg, B, 12, device="cpu")
    compiled = _jax_decode(jcfg)
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
    assert tstate["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(tstate["k"]), _np(jstate["k"]),
                               **TOL[dtype])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode must reproduce the full-sequence logits (the
    port's copy of tests/test_models.py's check, bf16 weights)."""
    tcfg = reduced_config(arch)
    tp = tt.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(tcfg))
    full, _ = tt.forward(tp, tcfg, toks, remat="none")
    state = tt.init_decode_state(tcfg, B, S + 4, device="cpu")
    outs = []
    for t in range(S):
        lg, state = tt.decode_step(tp, tcfg, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), atol=0.15, rtol=0.05)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3-405b"])
def test_decode_past_max_seq_clamps_like_jax(arch):
    """At pos >= max_seq, lax.dynamic_update_slice_in_dim clamps the write to
    the last slot; the port writes there too, and attends over every slot."""
    jcfg, tcfg, jp, tp = _both(arch, jnp.float32)
    max_seq, steps = 5, 9
    toks = _tokens(jcfg, seed=2, shape=(B, steps))
    jstate = jt.init_decode_state(jcfg, B, max_seq)
    tstate = tt.init_decode_state(tcfg, B, max_seq, device="cpu")
    step = _jax_decode(jcfg)
    for t in range(steps):
        want, jstate = step(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        got, tstate = tt.decode_step(tp, tcfg, tstate,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL[jnp.float32])
    assert tstate["pos"] == steps > max_seq
    np.testing.assert_allclose(_np(tstate["v"]), _np(jstate["v"]),
                               **TOL[jnp.float32])


@pytest.mark.parametrize("arch", ALL_PORTED)
def test_build_specs_on_meta_match_jax(arch):
    """Full-size specs: same names, shapes and dtypes, nothing allocated."""
    jspecs = jax.tree.map(lambda s: (s.shape, np.dtype(s.dtype).name),
                          jt.build_specs(JAX_CONFIGS[arch]),
                          is_leaf=lambda x: hasattr(x, "axes"))
    abstract = tt.abstract_params(get_config(arch))
    got = {path: (tuple(t.shape), str(t.dtype)[6:])
           for path, t in tree_leaves(abstract)}
    want = {tuple(k.key for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert got == want
    assert all(t.device.type == "meta" for _, t in tree_leaves(abstract))


def test_configs_are_copies_of_the_reference():
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert (dataclasses.asdict(cfg)
                == dataclasses.asdict(JAX_CONFIGS[name])), name
        assert (dataclasses.asdict(reduced_config(name))
                == dataclasses.asdict(jax_reduced_config(name))), name


def test_init_params_follows_the_jax_rule():
    """normal x scale/sqrt(fan_in), ones, zeros; deterministic per seed."""
    cfg = reduced_config("qwen2.5-14b")
    a = tt.init_params(cfg, torch.Generator().manual_seed(3))
    b = tt.init_params(cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(tree_leaves(a), tree_leaves(b)))
    blocks = a["blocks"]
    assert torch.equal(blocks["attn_norm"], torch.ones_like(blocks["attn_norm"]))
    assert torch.equal(blocks["bq"], torch.zeros_like(blocks["bq"]))
    w_up = blocks["w_up"].float()                       # (L, d, f): fan_in d
    assert abs(float(w_up.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    emb = a["embed"].float()                            # (V, d): fan_in V
    assert abs(float(emb.std()) * np.sqrt(cfg.vocab) - 1.0) < 0.05
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(a))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b",
                                  "llama-3.2-vision-90b"])
def test_init_params_each_hook_keeps_the_draws(arch):
    """``each(path, leaf)`` takes every leaf in the draw order and moves no
    draw: an identity hook gives the same bits as none, and a hook that
    keeps a slice of each leaf (as a rank keeps its shard) gives the same
    slices."""
    cfg = reduced_config(arch)
    whole = tree_leaves(tt.init_params(cfg, torch.Generator().manual_seed(4)))
    seen = []

    def identity(path, t):
        seen.append(path)
        return t

    def first_half(path, t):
        return t if t.dim() == 0 else t[:max(1, t.shape[0] // 2)].clone()
    same = tree_leaves(tt.init_params(cfg, torch.Generator().manual_seed(4),
                                      each=identity))
    halves = tree_leaves(tt.init_params(
        cfg, torch.Generator().manual_seed(4), each=first_half))
    assert seen == [path for path, _ in whole]
    for (path, a), (p1, b), (p2, h) in zip(whole, same, halves):
        assert path == p1 == p2
        assert torch.equal(a, b)
        assert torch.equal(a if a.dim() == 0 else a[:h.shape[0]], h)


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """A leaf of more than ``INIT_CHUNK`` values is drawn slice by slice
    along its leading axis (each slice of at most ``INIT_CHUNK`` values, or
    one leading index) into its output: same seed, same values; the values
    are the generator's draws for those slices in turn; the std rule
    holds."""
    from repro_torch.models import params
    from repro_torch.models.params import p, tree_init
    specs = {"a": p((6, 40, 50), ("layers", "embed", "ffn")),
             "b": p((3, 7), ("embed", "ffn"), init="ones"),
             "c": p((700, 30), ("embed_vocab", "embed"), scale=1.0)}
    whole = tree_init(specs, torch.Generator().manual_seed(5))
    monkeypatch.setattr(params, "INIT_CHUNK", 4000)
    x = tree_init(specs, torch.Generator().manual_seed(5))
    y = tree_init(specs, torch.Generator().manual_seed(5))
    assert all(torch.equal(x[k], y[k]) for k in specs)
    gen = torch.Generator().manual_seed(5)
    a = [torch.randn((2, 40, 50), generator=gen) for _ in range(3)]
    c = [torch.randn(shape, generator=gen) for shape in ((133, 30),) * 5
         + ((35, 30),)]
    torch.testing.assert_close(
        x["a"], (torch.cat(a) * (1.0 / math.sqrt(40))).to(torch.bfloat16),
        atol=0, rtol=0)
    torch.testing.assert_close(
        x["c"], (torch.cat(c) * (1.0 / math.sqrt(700))).to(torch.bfloat16),
        atol=0, rtol=0)
    assert torch.equal(x["b"], torch.ones(3, 7, dtype=torch.bfloat16))
    assert {k: v.shape for k, v in whole.items()} == {
        k: v.shape for k, v in x.items()}
    assert abs(float(x["a"].float().std()) * np.sqrt(40) - 1.0) < 0.05
    assert abs(float(x["c"].float().std()) * np.sqrt(700) - 1.0) < 0.05
    assert all(t.dtype == torch.bfloat16 for t in x.values())
