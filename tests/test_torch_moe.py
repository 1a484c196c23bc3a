"""The port's MoE family (``repro_torch.models.moe`` and the ``moe``
branches of ``models/transformer``) against the JAX package's, on the CPU.

Reduced ``granite-moe-3b-a800m`` (tied embeddings) and ``qwen3-moe-30b-a3b``
(qk_norm, untied head): 4 experts, top-2.  Weights are JAX-initialised and
carried over by ``params_from_jax``; inputs are drawn with numpy from a seed.

Routing is discrete: a tie in the router's top-k may order differently in
``jax.lax.top_k`` and ``torch.topk``, and a last-bit change may move a
token's k-th expert.  So each check of ``moe_ffn`` first asserts that the
inputs have no tie at the k-th place and that both frameworks pick the same
experts for every token, then compares outputs.  For the same reason the
bf16 checks hold the port to the reference run op by op
(``jax.disable_jit``): compiled by XLA on the CPU, the reference's bf16
router logits round at other places than its own op-by-op run, which moves
tokens to other experts and its bf16 logits by up to 1.8 on these reduced
models (ROADMAP Queue 3); the f32 checks use the compiled reference.

Tolerances: f32 at atol = rtol = 1e-4 (f32 rounding; the frameworks sum in
other orders), bf16 at the JAX package's prefill-vs-decode tolerance, atol
0.15 / rtol 0.05 (tests/test_models.py); gradients at 1e-4 of each leaf's
largest magnitude and the trajectory's params at 1e-3, as
tests/test_torch_train.py holds the dense family.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels import rmsnorm as jax_rmsnorm
from repro.launch.mesh import make_local_mesh
from repro.models import moe as jm
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import rmsnorm
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step, make_value_and_grad

from conftest import requires_mesh_axis_types

ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
TOL = {jnp.float32: dict(atol=1e-4, rtol=1e-4),
       jnp.bfloat16: dict(atol=0.15, rtol=0.05)}
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jax_params(arch, dtype=jnp.float32):
    """JAX init, with every norm weight perturbed from numpy (not all
    ones), cast to ``dtype``."""
    cfg = jax_reduced_config(arch)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    blocks = dict(params["blocks"])
    for name in blocks:
        if name.endswith("norm"):
            blocks[name] = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=blocks[name].shape), jnp.bfloat16)
    params = dict(params, blocks=blocks,
                  final_norm=jnp.asarray(1.0 + 0.1 * rng.normal(
                      size=params["final_norm"].shape), jnp.bfloat16))
    return cfg, jax.tree.map(lambda a: a.astype(dtype), params)


def _both(arch, dtype=jnp.float32):
    jcfg, jp = _jax_params(arch, dtype)
    return jcfg, reduced_config(arch), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def _layer(tree, i):
    return {k: v[i] for k, v in tree["blocks"].items()}


def _torch_dtype(dtype):
    return torch.float32 if dtype == jnp.float32 else torch.bfloat16


def _reference(fn, dtype, *args):
    """The reference ``fn(*args)``: compiled in f32, op by op in bf16."""
    if dtype == jnp.float32:
        return jax.jit(fn)(*args)
    with jax.disable_jit():
        return fn(*args)


def _routing(jx, tx, dtype, jlp, tlp, jcfg, tcfg):
    """The top-k expert sets of the reference for the tokens of ``jx`` and
    of the port for those of ``tx`` (f32 numpy of values exact in
    ``dtype``, (B, S, d)), each from its own RMSNorm and router product in
    ``dtype``; asserts that no token's k-th and (k+1)-th router logits tie
    in the port's arithmetic.  Returns (jax sets, torch sets, the torch
    expert ids (T, k))."""
    k, d = tcfg.top_k, tcfg.d_model
    with jax.disable_jit():
        jh = jax_rmsnorm(jnp.asarray(jx, dtype), jlp["ffn_norm"],
                         jcfg.norm_eps)
        jlog = (jh.reshape(-1, d) @ jlp["router"]).astype(jnp.float32)
        _, ji = jax.lax.top_k(jax.nn.softmax(jlog, axis=-1), k)
    th = rmsnorm(torch.from_numpy(np.array(tx)).to(_torch_dtype(dtype)),
                 tlp["ffn_norm"], tcfg.norm_eps)
    tlog = (th.reshape(-1, d) @ tlp["router"]).float()
    srt = torch.sort(tlog, dim=-1, descending=True).values
    assert bool((srt[:, k - 1] > srt[:, k]).all()), "router tie at top-k"
    ti = torch.topk(torch.softmax(tlog, -1), k, dim=-1).indices
    return (np.sort(np.asarray(ji), -1), np.sort(ti.numpy(), -1), ti)


# ------------------------------------------------------------- moe_ffn

# (B, S, skew): T = B*S against E = 4 experts, top-2: T <= E (C = T),
# E < T <= 4E (C raised to at least k), and T = 96 with tokens pushed
# towards a few experts (a shared direction added to every token), so that
# capacity (int(1.25 * T * k / E) = 60) drops some.
FFN_CASES = {"t_le_e": (1, 4, 0.0), "e_lt_t_le_4e": (2, 6, 0.0),
             "drops": (4, 24, 3.0)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", sorted(FFN_CASES))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_moe_ffn_matches_jax(arch, case, dtype):
    B, S, skew = FFN_CASES[case]
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    jlp, tlp = _layer(jp, 0), _layer(tp, 0)
    rng = np.random.default_rng(7)
    d = tcfg.d_model
    x = (rng.normal(size=(B, S, d)) + skew * rng.normal(size=d)).astype(
        np.float32)
    x = np.asarray(jnp.asarray(x, dtype), np.float32)
    jr, tr, top_i = _routing(x, x, dtype, jlp, tlp, jcfg, tcfg)
    np.testing.assert_array_equal(tr, jr)

    T, E = B * S, tcfg.n_experts
    C = tm.capacity(tcfg, T)
    load = np.bincount(top_i.numpy().ravel(), minlength=E)
    if case == "t_le_e":
        assert C == T
    elif case == "e_lt_t_le_4e":
        assert E < T <= 4 * E and C == int(1.25 * T * tcfg.top_k / E)
    else:
        assert T > 4 * E and C < T and load.max() > C, (C, load)
    want, jaux = _reference(lambda x, lp: jm.moe_ffn(x, lp, jcfg), dtype,
                            jnp.asarray(x, dtype), jlp)
    xt = torch.from_numpy(x).to(_torch_dtype(dtype))
    got, aux = tm.moe_ffn(xt, tlp, tcfg)
    assert got.dtype == xt.dtype and got.shape == (B, S, d)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), **TOL[jnp.float32])


def test_capacity_rule_matches_the_reference():
    """The static capacity, from the reference's literal rule, over token
    counts around each branch's edges and the full configs' shapes."""
    from repro_torch.configs import get_config

    def ref(cfg, T):
        E, k = cfg.n_experts, cfg.top_k
        C = min(max(1, int(cfg.capacity_factor * T * k / E)), T)
        if T <= 4 * E:
            C = min(T, max(C, k))
            C = T if T <= E else C
        return C
    for arch in ARCHS:
        for cfg in (reduced_config(arch), get_config(arch)):
            for T in (1, 2, 3, 4, 5, 8, 16, 17, 40, 41, 160, 161, 512, 513,
                      4096):
                assert tm.capacity(cfg, T) == ref(cfg, T), (arch, T)
    big = get_config("qwen3-moe-30b-a3b")
    assert tm.capacity(big, 4) == 4 and tm.capacity(big, 4096) == 320


def test_moe_combine_adds_in_expert_order():
    """Each token's k rows are added in ascending expert id, whatever order
    top-k returned them in: the output of one token equals the sum, in that
    order, of its experts' weighted outputs."""
    cfg = dataclasses.replace(reduced_config(ARCHS[0]), top_k=3)
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0))
    lp = {k: v.float() for k, v in _layer(tp, 0).items()}
    x = torch.randn(1, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    out, _ = tm.moe_ffn(x, lp, cfg)
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)[0]
    probs = torch.softmax((h @ lp["router"]).float(), -1)
    top_p, top_i = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    for t in range(3):
        acc = torch.zeros(cfg.d_model)
        for j in torch.argsort(top_i[t]).tolist():
            e = int(top_i[t, j])
            g = torch.nn.functional.silu(h[t] @ lp["w_gate"][e])
            acc = acc + ((g * (h[t] @ lp["w_up"][e])) @ lp["w_down"][e]
                         ) * top_p[t, j]
        torch.testing.assert_close(out[0, t], acc, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------- the model

def _spy(monkeypatch, module, seen):
    """Record the layer input of every ``moe_ffn`` call through
    ``module``."""
    real = module.moe_ffn

    def spy(x, lp, cfg, **kw):
        seen.append(np.asarray(_np(x) if torch.is_tensor(x)
                               else x.astype(jnp.float32)))
        return real(x, lp, cfg, **kw)
    monkeypatch.setattr(module, "moe_ffn", spy)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_logits_and_aux_match_jax(arch, dtype, monkeypatch):
    """Logits and the aux loss summed over the layers, against the
    reference run op by op (and, in f32, compiled); every layer routes the
    same tokens to the same experts in both."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 16))
    if dtype == jnp.float32:
        compiled = jax.jit(lambda p, t: jt.forward(p, jcfg, t,
                                                   remat="none"))(
            jp, jnp.asarray(toks))
    jseen, tseen = [], []
    _spy(monkeypatch, jt, jseen)
    _spy(monkeypatch, tt, tseen)
    with jax.disable_jit():
        want, jaux = jt.forward(jp, jcfg, jnp.asarray(toks), remat="none")
    got, aux = tt.forward(tp, tcfg, torch.from_numpy(toks), remat="none")
    assert len(jseen) == len(tseen) == tcfg.n_layers
    for i, (jx, tx) in enumerate(zip(jseen, tseen)):
        jr, tr, _ = _routing(jx, tx, dtype, _layer(jp, i), _layer(tp, i),
                             jcfg, tcfg)
        np.testing.assert_array_equal(tr, jr)
    assert got.shape == (2, 16, tcfg.vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), **TOL[jnp.float32])
    if dtype == jnp.float32:
        np.testing.assert_allclose(_np(got), _np(compiled[0]), **TOL[dtype])
        np.testing.assert_allclose(float(aux), float(compiled[1]),
                                   **TOL[dtype])
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_steps_match_jax(arch, dtype):
    """8 decode steps from an empty cache against the reference's
    ``decode_step``: every expert runs (C = T = B), nothing drops."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    B = 2
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, 8))
    jstate = jt.init_decode_state(jcfg, B, 12)
    tstate = tt.init_decode_state(tcfg, B, 12, device="cpu")
    step = jax.jit(lambda p, s, t: jt.decode_step(p, jcfg, s, t))
    for t in range(8):
        want, jstate = step(jp, jstate, jnp.asarray(toks[:, t:t + 1]))
        got, tstate = tt.decode_step(tp, tcfg, tstate,
                                     torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert tstate["pos"] == int(jstate["pos"]) == 8
    np.testing.assert_allclose(_np(tstate["k"]), _np(jstate["k"]),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tstate["v"]), _np(jstate["v"]),
                               **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces the full-sequence logits (bf16
    weights; tests/test_models.py's check and tolerance, with its
    drop-free capacity factor 8 so that prefill and decode route alike)."""
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=8.0)
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    assert tm.capacity(cfg, 32) == 32
    full, _ = tt.forward(tp, cfg, toks, remat="none")
    state = tt.init_decode_state(cfg, 2, 20, device="cpu")
    outs = []
    for t in range(16):
        lg, state = tt.decode_step(tp, cfg, state, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               atol=0.15, rtol=0.05)


# ------------------------------------------------------------ training

def _batch(vocab, B=4, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf_close(got, want, tol, what=""):
    """Within ``tol`` of the leaf's largest magnitude."""
    got, want = _np(got), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def _jax_grads():
    """The reference's loss (with the aux term) and gradients, per arch and
    loss, computed once."""
    cache = {}

    def get(arch, loss_impl):
        if (arch, loss_impl) not in cache:
            jcfg, jp = _jax_params(arch)
            batch = _batch(jcfg.vocab)

            def jloss(p):
                out, aux = jt.forward(p, jcfg, batch["tokens"], remat="none",
                                      return_hidden=loss_impl == "chunked")
                if loss_impl == "chunked":
                    return jt.lm_loss_chunked(out, p, jcfg, batch["labels"],
                                              aux)
                return jt.lm_loss(out, batch["labels"], aux)
            jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
            cache[arch, loss_impl] = (jp, batch, float(jl), dict(
                tree_leaves(jax.tree.map(np.asarray, jg))))
        return cache[arch, loss_impl]
    return get


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_model_gradients_match_jax(arch, remat, _jax_grads):
    """Loss and every gradient leaf of ``make_value_and_grad`` (the train
    step's own loss, aux term included) against ``jax.value_and_grad`` of
    the reference's; the gradient reaches the router through the
    renormalised top-k weights and through the aux loss."""
    jp, batch, jl, jg = _jax_grads(arch, "dense")
    cfg = reduced_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    loss, grads = make_value_and_grad(cfg, remat=remat)(
        tp, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), jl, atol=1e-5, rtol=1e-5)
    flat = dict(tree_leaves(grads))
    assert sorted(flat) == sorted(jg)
    for path, g in flat.items():
        _leaf_close(g, jg[path], 1e-4, path)
    assert float(flat[("blocks", "router")].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_gradients_match_jax(arch, _jax_grads):
    jp, batch, jl, jg = _jax_grads(arch, "chunked")
    cfg = reduced_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    loss, grads = make_value_and_grad(cfg, remat="full", loss_impl="chunked")(
        tp, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), jl, atol=1e-5, rtol=1e-5)
    for path, g in tree_leaves(grads):
        _leaf_close(g, jg[path], 1e-4, path)


def test_aux_term_reaches_the_loss():
    """The train step's loss is the cross-entropy plus 0.01 x the summed
    aux, as the reference's ``lm_loss(logits, labels, aux)``."""
    cfg = reduced_config(ARCHS[0])
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tp = {k: (v.float() if torch.is_tensor(v) else
              {n: t.float() for n, t in v.items()}) for k, v in tp.items()}
    b = _torch_batch(_batch(cfg.vocab))
    loss, _ = make_value_and_grad(cfg, remat="none")(tp, b)
    logits, aux = tt.forward(tp, cfg, b["tokens"], remat="none")
    ce = tt.lm_loss(logits, b["labels"])
    torch.testing.assert_close(loss, ce + 0.01 * aux)
    assert float(aux) > 0.5 * cfg.n_layers


def test_dots_saves_the_router_product_and_recomputes_the_experts(
        monkeypatch):
    """``remat="dots"`` keeps only ``aten.mm`` outputs: per layer the q, k,
    v and o projections and the router; the experts' three batched products
    (``aten.bmm``) are recomputed, as JAX's
    ``dots_with_no_batch_dims_saveable`` treats a batched einsum.  The
    gradients equal those of ``remat="none"`` bit for bit."""
    cfg = reduced_config(ARCHS[1])
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0))
    tp = {k: (v.float() if torch.is_tensor(v) else
              {n: t.float() for n, t in v.items()}) for k, v in tp.items()}
    b = _torch_batch(_batch(cfg.vocab))
    base_loss, base = make_value_and_grad(cfg, remat="none")(tp, b)
    seen = []
    real = tt._save_mm

    def spy(ctx, op, *args, **kwargs):
        decision = real(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision
    monkeypatch.setattr(tt, "_save_mm", spy)
    loss, grads = make_value_and_grad(cfg, remat="dots")(tp, b)
    saved = [op for op, dec in seen if dec.name == "MUST_SAVE"]
    assert set(saved) == {torch.ops.aten.mm.default}
    assert len(saved) == 5 * cfg.n_layers
    bmm = [dec.name for op, dec in seen if op == torch.ops.aten.bmm.default]
    assert len(bmm) >= 3 * cfg.n_layers
    assert set(bmm) == {"PREFER_RECOMPUTE"}
    assert torch.equal(loss, base_loss)
    for (path, g), (_, g0) in zip(tree_leaves(grads), tree_leaves(base)):
        assert torch.equal(g, g0), path


@requires_mesh_axis_types
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_trajectory_matches_jax_train_step(arch):
    """Two AdamW steps of ``make_train_step`` against the reference's."""
    jcfg, jp = _jax_params(arch)
    cfg = reduced_config(arch)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt.AdamWConfig(**kw),
                                        make_local_mesh(), None,
                                        remat="none"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tstep = make_train_step(cfg, topt.AdamWConfig(**kw), remat="full")
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for i in range(2):
        batch = _batch(cfg.vocab, seed=20 + i)
        jp, js, jmet = jstep(jp, js, batch)
        tp, ts, tmet = tstep(tp, ts, _torch_batch(batch))
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   atol=1e-4, rtol=1e-4)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(tp):
        _leaf_close(t, jflat[path], 1e-3, path)


def test_checkpoints_cross_both_ways(tmp_path):
    """A MoE param tree (bf16) with its AdamW state, written by one package
    and restored by the other, bit for bit."""
    _, jp = _jax_params(ARCHS[1], jnp.bfloat16)
    rng = np.random.default_rng(5)
    js = jopt.init_state(jp)
    js = jopt.AdamWState(jnp.asarray(3, jnp.int32), jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), js.mu),
        js.nu)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    JaxCheckpointManager(tmp_path / "jax").save(1, (jp, js), {"step": 1})
    (rp, rs), extra = CheckpointManager(tmp_path / "jax").restore(
        (tp, topt.init_state(tp)))
    assert extra == {"step": 1} and int(rs.step) == 3
    for (path, t), (_, a) in zip(tree_leaves(rp),
                                 tree_leaves(jax.tree.map(np.asarray, jp))):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32))
    assert ("blocks", "w_down") in dict(tree_leaves(rp))
    CheckpointManager(tmp_path / "torch").save(2, (rp, rs), {"step": 2})
    (bp, bs), extra = JaxCheckpointManager(tmp_path / "torch").restore(
        (jp, jopt.init_state(jp)))
    assert extra == {"step": 2} and int(bs.step) == 3
    for a, b in zip(jax.tree.leaves((bp, bs)), jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    keys = [[leaf["key"] for leaf in json.loads(
        (tmp_path / d / "manifest.json").read_text())["leaves"]]
        for d in ("jax/step_00000001", "torch/step_00000002")]
    assert keys[0] == keys[1]


# ---------------------------------------------------------- entry points

def test_serve_example_serves_moe_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_llm_torch.py"),
         "--device", "cpu", "--arch", ARCHS[0], "--requests", "5",
         "--max-new", "4"], capture_output=True, text=True, timeout=300,
        check=True).stdout
    assert "served 5 requests, 20 tokens" in out


def test_moe_trains_and_serves_through_the_entry_points():
    """``make_prefill``, ``make_serve_step`` and ``ServingEngine`` on a
    reduced MoE model on the CPU: finite logits, every request answered."""
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    cfg = reduced_config(ARCHS[1])
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12))
    logits = make_prefill(cfg, "cpu")(tp, toks)
    assert logits.shape == (2, 12, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    state = tt.init_decode_state(cfg, 2, 16, device="cpu")
    lg, state = make_serve_step(cfg, "cpu")(tp, state, toks[:, :1])
    assert lg.shape == (2, 1, cfg.vocab) and state["pos"] == 1
    eng = ServingEngine(tp, cfg, batch=2, max_seq=32, device="cpu")
    for rid in range(3):
        eng.submit(Request(rid, toks[rid % 2, :5], max_new=3))
    done = eng.run()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.output) == 3 for r in done)
