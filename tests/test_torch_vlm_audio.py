"""The port's vlm (llama-3.2-vision-90b) and audio (musicgen-large) families
against the JAX package's on the CPU: forward, the clamped cross-attention
index, decode on an image state and on frame embeddings, prefill against
decode, the image K/V of ``init_decode_state``, gradients under every remat
and both losses, AdamW steps, checkpoints both ways, the launcher, the
serving engine, and the kernel cases these families add (RMSNorm of a bf16
x with an f32 weight; flash attention with one query row over a ragged
key count; an f32 q over bf16 k / v).

Audio under f32 weights takes bf16 frame embeddings into f32 layers (the
reference casts ``inputs_embeds`` to bf16 whatever the params' type), so
its activations turn f32 after the first layer; the reference's jitted
``lax.scan`` refuses a carry whose type changes, so those references run op
by op (``jax.disable_jit``, ``_reference``).

Weights are JAX-initialised reduced configs carried over by
``params_from_jax``, with norm weights drawn from numpy and every
``ca_gate`` set to 0.5 + 0.1 N(0, 1): the init's zero gate (tanh(0) = 0)
would hide any cross-attention error.  Image and frame embeddings are drawn
from a seed in bf16, the type ``batch_structs`` declares.

Tolerances: f32 weights at 1e-4 (tests/test_torch_models.py), bf16 weights
at atol 0.15 / rtol 0.05 (the reference's prefill-vs-decode tolerance);
gradients at 1e-4 of each leaf's largest magnitude, AdamW losses and grad
norms at 1e-4 and the params after 4 steps at 1e-3 of each leaf's largest
magnitude (tests/test_torch_train.py: AdamW's m / (sqrt(v) + eps) turns the
last bits of a gradient near zero into larger steps); the kernels' plain versions at
their forward tolerances (tests/test_kernels.py: flash attention 5e-5 in
f32, the Pallas interpret check 1e-4; RMSNorm 1e-5 in f32, one bf16 ulp of
the value in bf16).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention import ref as jax_fa
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.rmsnorm import ref as jax_rms
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jt
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServingEngine as JaxServingEngine
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref, rmsnorm_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.serve.serve_step import make_prefill, make_serve_step
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step, make_value_and_grad

from conftest import requires_mesh_axis_types

VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
ARCHS = (VLM, AUDIO)
TOL = {jnp.float32: dict(atol=1e-4, rtol=1e-4),
       jnp.bfloat16: dict(atol=0.15, rtol=0.05)}
B, S = 2, 16
ENGINE_TOL = 1e-3      # f32 weights over a bf16 KV cache (test_torch_ssm.py)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores;
    restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _leaf_close(got, want, tol=1e-4, what=""):
    """Within ``tol`` of the leaf's largest magnitude."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _perturb(tree, rng):
    """Norm weights 1 + 0.1 N(0, 1) and gates 0.5 + 0.1 N(0, 1), from
    numpy."""
    out = dict(tree)
    for name, leaf in tree.items():
        if name.endswith("norm"):
            out[name] = jnp.asarray(1 + 0.1 * rng.normal(size=leaf.shape),
                                    jnp.bfloat16)
        elif name == "ca_gate":
            out[name] = jnp.asarray(0.5 + 0.1 * rng.normal(size=leaf.shape),
                                    jnp.bfloat16)
    return out


def _configs(arch, **changes):
    return (dataclasses.replace(jax_reduced_config(arch), **changes),
            dataclasses.replace(reduced_config(arch), **changes))


def _both(arch, dtype, **changes):
    """(JAX cfg, port cfg, JAX params, port params) on the same weights."""
    jcfg, tcfg = _configs(arch, **changes)
    params = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    params = dict(params, blocks=_perturb(params["blocks"], rng),
                  final_norm=_perturb({"final_norm": params["final_norm"]},
                                      rng)["final_norm"])
    if "cross" in params:
        params["cross"] = _perturb(params["cross"], rng)
    jp = jax.tree.map(lambda a: a.astype(dtype), params)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, seed=0, batch=B, seq=S):
    """NumPy inputs of one (prefill or train) call: token ids, or audio's
    frame embeddings, and a vlm's image embeddings; embeddings in bf16."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16))
    kw = {}
    if cfg.family == "audio":
        kw["inputs_embeds"] = bf16((batch, seq, cfg.d_model))
    else:
        kw["tokens"] = rng.integers(0, cfg.vocab, (batch, seq))
    if cfg.family == "vlm":
        kw["img_embeds"] = bf16((batch, cfg.n_image_tokens, cfg.d_model))
    return kw


def _reference(fn, cfg, dtype):
    """``fn`` jitted, or op by op for audio under f32 weights (the module
    docstring says why)."""
    if cfg.family != "audio" or dtype != jnp.float32:
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def _jax_forward(cfg, dtype):
    return _reference(lambda p, kw: jt.forward(
        p, cfg, kw.get("tokens"), inputs_embeds=kw.get("inputs_embeds"),
        img_embeds=kw.get("img_embeds"), remat="none")[0], cfg, dtype)


def _torch_forward(tp, cfg, kw, **extra):
    tk = params_from_jax(kw, "cpu")
    return tt.forward(tp, cfg, tk.get("tokens"),
                      inputs_embeds=tk.get("inputs_embeds"),
                      img_embeds=tk.get("img_embeds"), **extra)[0]


# ------------------------------------------------------------- forward

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_forward_matches_jax(arch, dtype):
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    kw = _inputs(jcfg)
    want = _jax_forward(jcfg, dtype)(jp, kw)
    got = _torch_forward(tp, tcfg, kw, remat="none")
    assert got.shape == (B, S, tcfg.vocab)
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if arch == VLM:
        # The gate lets the image through: with it at zero the logits move.
        shut = dict(tp, cross=dict(tp["cross"], ca_gate=torch.zeros_like(
            tp["cross"]["ca_gate"])))
        assert np.abs(_np(_torch_forward(shut, tcfg, kw, remat="none"))
                      - _np(got)).max() > 2 * TOL[dtype]["atol"]


def test_cross_index_clamps_to_the_last_cross_layer():
    """3 layers with a cross layer every 2: n_ca = 1, layers 0 and 2 fire,
    and layer 2's index 2 // 2 = 1 clamps to 0 (``lax.dynamic_index_in_dim``
    clamps it in the reference)."""
    jcfg, tcfg, jp, tp = _both(VLM, jnp.float32, n_layers=3)
    assert tp["cross"]["ca_wq"].shape[0] == 1
    assert [tt._cross_index(tcfg, i, 1) for i in (0, 2)] == [0, 0]
    kw = _inputs(jcfg, seed=5)
    np.testing.assert_allclose(_np(_torch_forward(tp, tcfg, kw, remat="none")),
                               _np(_jax_forward(jcfg, jnp.float32)(jp, kw)),
                               **TOL[jnp.float32])


def test_image_state_of_init_decode_state_matches_jax():
    """``init_decode_state(img_embeds, params)``: each cross layer's K and
    V of the image (stacked, (n_ca, B, n_img, KV, hd)); without them, bf16
    zeros of that shape."""
    jcfg, tcfg, jp, tp = _both(VLM, jnp.float32)
    img = _inputs(jcfg, seed=2)["img_embeds"]
    want = jt.init_decode_state(jcfg, B, 8, img_embeds=jnp.asarray(img),
                                params=jp)["img_kv"]
    got = tt.init_decode_state(tcfg, B, 8, device="cpu",
                               img_embeds=params_from_jax(img, "cpu"),
                               params=tp)["img_kv"]
    n_ca = tcfg.n_layers // tcfg.cross_attn_every
    shape = (n_ca, B, tcfg.n_image_tokens, tcfg.n_kv_heads, tcfg.hd)
    for g, w in zip(got, want):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)
    zk, zv = tt.init_decode_state(tcfg, B, 8, device="cpu")["img_kv"]
    assert zk.shape == shape and zk.dtype == torch.bfloat16
    assert not zk.any() and not zv.any()


# -------------------------------------------------------------- decode

def _step_inputs(cfg, kw, t):
    """Decode step t's input: one token id, or one frame embedding."""
    if cfg.family == "audio":
        return {"inputs_embeds": kw["inputs_embeds"][:, t:t + 1]}
    return {"tokens": kw["tokens"][:, t:t + 1]}


def _states(jcfg, tcfg, jp, tp, kw, max_seq):
    img = kw.get("img_embeds")
    jstate = jt.init_decode_state(
        jcfg, B, max_seq, params=jp,
        img_embeds=None if img is None else jnp.asarray(img))
    tstate = tt.init_decode_state(
        tcfg, B, max_seq, device="cpu", params=tp,
        img_embeds=None if img is None else params_from_jax(img, "cpu"))
    return jstate, tstate


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_decode_steps_match_jax(arch, dtype):
    """8 decode steps (vlm on an image state, audio on frame embeddings)
    through ``make_serve_step`` against JAX's ``decode_step``.  Under f32
    weights the new k / v still go into a bf16 cache, and the two
    frameworks' f32 products differ in the last bit, so a value next to a
    bf16 rounding tie is cached one bf16 ulp apart (audio's step 0 does it):
    f32 is held at ENGINE_TOL, as tests/test_torch_ssm.py holds f32 logits
    over a bf16 cache, and the caches within one bf16 ulp."""
    jcfg, tcfg, jp, tp = _both(arch, dtype)
    kw = _inputs(jcfg, seed=1, seq=8)
    jstate, tstate = _states(jcfg, tcfg, jp, tp, kw, 12)
    jstep = _reference(lambda p, s, i: jt.decode_step(
        p, jcfg, s, i.get("tokens"), inputs_embeds=i.get("inputs_embeds")),
        jcfg, dtype)
    tstep = make_serve_step(tcfg, "cpu")
    for t in range(8):
        step_in = _step_inputs(jcfg, kw, t)
        want, jstate = jstep(jp, jstate, step_in)
        got, tstate = tstep(tp, tstate, **params_from_jax(step_in, "cpu"))
        assert got.shape == (B, 1, tcfg.vocab)
        tol = (dict(atol=ENGINE_TOL, rtol=ENGINE_TOL)
               if dtype == jnp.float32 else TOL[dtype])
        np.testing.assert_allclose(_np(got), _np(want), **tol,
                                   err_msg=f"step {t}")
    assert tstate["pos"] == 8
    for name in ("k", "v") if dtype == jnp.float32 else ():
        np.testing.assert_allclose(_np(tstate[name]), _np(jstate[name]),
                                   atol=1e-6, rtol=2 ** -7)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """Teacher-forced decode reproduces ``make_prefill``'s logits at the
    reference's tolerance (tests/test_models.py), bf16 weights."""
    _, tcfg, _, tp = _both(arch, jnp.bfloat16)
    kw = _inputs(tcfg, seed=3)
    tk = params_from_jax(kw, "cpu")
    full = make_prefill(tcfg, "cpu")(tp, **tk)
    state = tt.init_decode_state(tcfg, B, S + 4, device="cpu", params=tp,
                                 img_embeds=tk.get("img_embeds"))
    step = make_serve_step(tcfg, "cpu")
    outs = []
    for t in range(S):
        lg, state = step(tp, state,
                         **params_from_jax(_step_inputs(tcfg, kw, t), "cpu"))
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               atol=0.15, rtol=0.05)


# ------------------------------------------------------------ training

def _batch(cfg, seed):
    kw = _inputs(cfg, seed=seed, batch=4)
    labels = np.random.default_rng(seed + 100).integers(0, cfg.vocab, (4, S))
    return {**kw, "labels": labels.astype(np.int32)}


def _jax_value_and_grad(jcfg, loss_impl, dtype=jnp.float32):
    def loss(p, batch):
        out, aux = jt.forward(p, jcfg, batch.get("tokens"),
                              inputs_embeds=batch.get("inputs_embeds"),
                              img_embeds=batch.get("img_embeds"),
                              remat="none",
                              return_hidden=loss_impl == "chunked")
        if loss_impl == "chunked":
            return jt.lm_loss_chunked(out, p, jcfg, batch["labels"])
        return jt.lm_loss(out, batch["labels"])
    return _reference(jax.value_and_grad(loss), jcfg, dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loss_impl", ["dense", "chunked"])
def test_model_gradients_match_jax(arch, loss_impl):
    """Loss and every leaf's gradient under each remat against
    ``jax.value_and_grad``; audio's ``embed`` (not reached under
    ``inputs_embeds``) gets zeros, as in JAX."""
    jcfg, tcfg, jp, tp = _both(arch, jnp.float32)
    batch = _batch(jcfg, seed=4)
    jl, jg = _jax_value_and_grad(jcfg, loss_impl)(jp, batch)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    tb = params_from_jax(batch, "cpu")
    for remat in ("none", "full", "dots"):
        loss, grads = make_value_and_grad(tcfg, remat=remat,
                                          loss_impl=loss_impl)(tp, tb)
        np.testing.assert_allclose(float(loss), float(jl), atol=1e-5,
                                   rtol=1e-5)
        for path, g in tree_leaves(grads):
            _leaf_close(g, jflat[path], 1e-4, (remat, path))
        if arch == AUDIO:
            assert not grads["embed"].any() and not np.any(jflat[("embed",)])
        else:
            assert float(grads["cross"]["ca_gate"].abs().min()) > 0


@requires_mesh_axis_types
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_steps_match_jax_train_step(arch):
    """4 steps of ``make_train_step`` (2 microbatches: every batch key is
    split) against the JAX package's: loss and grad norm of every step at
    1e-4, the final params at 1e-3 of each leaf's largest magnitude.  Audio's
    ``embed`` moves by weight decay alone in both."""
    jcfg, tcfg, jp, tp = _both(arch, jnp.float32)
    opt = dict(lr=1e-2, warmup_steps=2, total_steps=4)
    jstep = _reference(jax_make_train_step(
        jcfg, jopt.AdamWConfig(**opt), make_local_mesh(), None, remat="none",
        microbatches=2), jcfg, jnp.float32)
    tstep = make_train_step(tcfg, topt.AdamWConfig(**opt), remat="full",
                            microbatches=2)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    embed0 = tp["embed"].clone()
    for i in range(4):
        batch = _batch(jcfg, seed=10 + i)
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, params_from_jax(batch, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), atol=1e-4,
                                   rtol=1e-4)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(tp):
        _leaf_close(t, jflat[path], 1e-3, path)
    if arch == AUDIO:
        assert not torch.equal(tp["embed"], embed0)
        np.testing.assert_allclose(_np(tp["embed"]) / _np(embed0),
                                   _np(tp["embed"])[0, 0] / _np(embed0)[0, 0],
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(tmp_path, arch):
    """bf16 params (a vlm's ``cross`` subtree and 1-D ``ca_gate`` included)
    and f32 moments: written by one package, restored by the other, bit for
    bit, under the same manifest keys."""
    _, _, jp, tp = _both(arch, jnp.bfloat16)
    rng = np.random.default_rng(5)
    js = jopt.init_state(jp)
    js = jopt.AdamWState(jnp.asarray(7, jnp.int32), jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), js.mu),
        js.nu)
    ts = topt.init_state(tp)
    JaxCheckpointManager(tmp_path / "jax").save(3, (jp, js), {"step": 3})
    (rp, rs), extra = CheckpointManager(tmp_path / "jax").restore((tp, ts))
    assert extra == {"step": 3} and int(rs.step) == 7
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(rp):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(_np(t), _np(want[path]))
    for (_, t), (_, a) in zip(tree_leaves(rs.mu), tree_leaves(
            jax.tree.map(np.asarray, js.mu))):
        np.testing.assert_array_equal(t.numpy(), a)
    if arch == VLM:
        assert rp["cross"]["ca_gate"].shape == (1,)
    CheckpointManager(tmp_path / "torch").save(3, (rp, rs), {"step": 3})
    (bp, bs), extra = JaxCheckpointManager(tmp_path / "torch").restore(
        (jp, jopt.init_state(jp)))
    assert extra == {"step": 3} and int(bs.step) == 7
    for a, b in zip(jax.tree.leaves((bp, bs)), jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_np(a), _np(b))
    keys = [[leaf["key"] for leaf in json.loads(
        (tmp_path / d / "manifest.json").read_text())["leaves"]]
        for d in ("jax/step_00000003", "torch/step_00000003")]
    assert keys[0] == keys[1]
    assert (arch != VLM) or any("['cross']['ca_gate']" in k for k in keys[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_and_resumes_on_cpu(tmp_path, capsys, arch):
    """The launcher on the reduced config, through the cached token
    pipeline (token ids, as the reference's launcher feeds both families):
    4 steps with checkpoints, then a resume to 6."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--cache-mb", "64", "--ckpt-dir", str(tmp_path),
            "--log-every", "2", "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[train] step     4" in out and "CHR" in out
    assert launch_train.main(args + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "2 steps" in out
    cfg = reduced_config(arch)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    (restored, state), extra = CheckpointManager(tmp_path).restore(
        (params, topt.init_state(params)))
    assert extra == {"step": 6} and int(state.step) == 6
    for name in ("wq", "w_down"):
        moved = restored["blocks"][name]
        assert bool(torch.isfinite(moved.float()).all())
        assert not torch.equal(moved, params["blocks"][name])


# ------------------------------------------------------------- serving

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


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    """Same f32 weights and requests through both engines (token ids; a vlm
    with the zero image of ``init_decode_state``): every step's logits
    within ENGINE_TOL, each row's top-1 / top-2 margin above it, the same
    tokens."""
    jcfg, tcfg, jp, tp = _both(arch, jnp.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jcfg.vocab, rng.integers(3, 9), dtype=np.int32)
               for _ in range(6)]
    jdone, jlog = _serve(
        JaxServingEngine(jp, jcfg, batch=4, max_seq=16),
        [JaxRequest(i, p, max_new=4) for i, p in enumerate(prompts)],
        lambda x: np.asarray(x, np.float32))
    tdone, tlog = _serve(
        ServingEngine(tp, tcfg, batch=4, max_seq=16, device="cpu"),
        [Request(i, p, max_new=4) for i, p in enumerate(prompts)],
        lambda x: x.float().numpy())
    assert len(tlog) == len(jlog) > 16
    for step, (a, b) in enumerate(zip(tlog, jlog)):
        np.testing.assert_allclose(a, b, atol=ENGINE_TOL, rtol=ENGINE_TOL,
                                   err_msg=f"step {step}")
        top2 = np.sort(b, axis=-1)[:, -2:]
        assert ((top2[:, 1] - top2[:, 0]) > ENGINE_TOL).all(), step
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert [r.output for r in tdone] == [r.output for r in jdone]
    assert len(tdone) == 6 and all(len(r.output) == 4 for r in tdone)


# ------------------------------------------------------ kernel cases

def test_mixed_dtype_rmsnorm_and_its_gradient_match_jax():
    """x bf16 with an f32 weight (audio's first norm under f32 weights):
    the output is bf16 (``rmsnorm_ref``'s arithmetic in f32, cast once), dx
    bf16 and dw f32, against ``rmsnorm_ref`` and ``jax.vjp``; the plain
    backward takes the same mix; other mixes raise."""
    rng = np.random.default_rng(6)
    x = np.asarray(jnp.asarray(rng.normal(size=(3, 5, 64)), jnp.bfloat16))
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    dy = np.asarray(jnp.asarray(rng.normal(size=(3, 5, 64)), jnp.bfloat16))
    want, vjp = jax.vjp(jax_rms.rmsnorm_ref, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw, tdy = (params_from_jax(a, "cpu") for a in (x, w, dy))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y = rmsnorm(tx, tw)
    assert y.dtype == torch.bfloat16
    ulp = dict(atol=1e-5, rtol=2 ** -7)            # one bf16 ulp of the value
    np.testing.assert_allclose(_np(y), _np(want), **ulp)
    np.testing.assert_allclose(_np(rmsnorm_ref(tx, tw)), _np(want), **ulp)
    dx, dw = torch.autograd.grad(y, (tx, tw), tdy)
    assert (dx.dtype, dw.dtype) == (torch.bfloat16, torch.float32)
    np.testing.assert_allclose(_np(dx), _np(jdx), **ulp)
    _leaf_close(dw, jdw, 1e-5)
    rdx, rdw = rmsnorm_bwd_ref(tx.detach(), tw.detach(), tdy)
    np.testing.assert_allclose(_np(rdx), _np(jdx), **ulp)
    _leaf_close(rdw, jdw, 1e-5)
    with pytest.raises(TypeError, match="rmsnorm"):
        rmsnorm(tx.detach().float(), tw.detach().to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_single_query_row_over_a_ragged_key_count(dtype):
    """Decode's cross-attention shape, reduced: q (B, 1, H, hd) non-causal
    over Skv = 37 keys (2 blocks of 16 and a ragged 5) in GQA groups of 2:
    the plain version against the reference's, the Pallas kernel in
    interpret mode (f32), and the autograd Function's CPU gradient against
    ``jax.vjp`` (f32)."""
    rng = np.random.default_rng(7)
    shapes = [(2, 1, 4, 16), (2, 37, 2, 16), (2, 37, 2, 16)]
    arrs = [np.asarray(jnp.asarray(rng.normal(size=s), dtype)) for s in shapes]
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    tq, tk, tv = (params_from_jax(a, "cpu") for a in arrs)
    want = jax_fa.flash_attention_ref(jq, jk, jv, causal=False, block_kv=16)
    got = flash_attention_ref(tq, tk, tv, causal=False, block_kv=16)
    tol = 5e-5 if dtype == jnp.float32 else 2e-2
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    if dtype == jnp.bfloat16:
        return
    pallas = flash_attention_pallas(jq, jk, jv, causal=False, block_q=1,
                                    block_kv=16, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=1e-4)
    do = rng.normal(size=shapes[0]).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention_ref(
        q, k, v, causal=False, block_kv=16), jq, jk, jv)
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    o = flash_attention(tq, tk, tv, causal=False, block_kv=16)
    for g, w in zip(torch.autograd.grad(o, (tq, tk, tv),
                                        torch.from_numpy(do)),
                    vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_np(g), _np(w), atol=5e-5)


def test_flash_f32_query_over_bf16_keys_and_values():
    """A vlm under f32 weights over the bf16 zero image state: q f32 with k,
    v bf16 computes in f32, as the reference does; the gradients come back
    in each input's type; another mix raises."""
    rng = np.random.default_rng(8)
    q = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    kv = [np.asarray(jnp.asarray(rng.normal(size=(2, 9, 2, 16)),
                                 jnp.bfloat16)) for _ in range(2)]
    want = jax_fa.flash_attention_ref(jnp.asarray(q), *map(jnp.asarray, kv),
                                      causal=False)
    tq = torch.from_numpy(q).requires_grad_(True)
    tk, tv = (params_from_jax(a, "cpu").requires_grad_(True) for a in kv)
    got = flash_attention(tq, tk, tv, causal=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=5e-5)
    grads = torch.autograd.grad(got.sum(), (tq, tk, tv))
    assert [g.dtype for g in grads] == [torch.float32, torch.bfloat16,
                                        torch.bfloat16]
    with pytest.raises(TypeError, match="flash_attention"):
        flash_attention(tq.detach().to(torch.bfloat16), tk.float(), tv.float())


@pytest.mark.parametrize("rows,d,itemsize,vecs", [
    (4096, 8192, 2, 4),       # llama-3.2-vision's d_model, bf16
    (640, 8192, 4, 8),        # ... in f32
    (100, 4096, 4, 4),        # the first f32 width past the row groups
    (7, 6144, 2, 4),          # fewer rows than CTAs
    (4096, 12288, 2, 4),      # mistral-large-123b's d_model, bf16
    (4096, 16384, 2, 4),      # llama3-405b's
    (4096, 12288, 4, 8),      # ... both in f32
    (4096, 16384, 4, 8),
    (7, 16384, 2, 4)])        # llama3-405b's decode rows
def test_rmsnorm_bwd_plan_for_long_rows(rows, d, itemsize, vecs):
    """Rows of more than 512 vectors take the long-row backward: one row a
    CTA of 256 threads, 4 vectors a thread (8 past 1024 vectors), on a
    one-wave grid of two CTAs an SM that strides over the rows.  Rows wider
    than 8192 take the wide-row backward: one row a CTA of 512 threads of
    32 elements (4 bf16 or 8 f32 vectors), one CTA an SM."""
    from repro_torch.kernels.rmsnorm.kernel import (BWD_LONG_CTAS_PER_SM,
                                                    BWD_LONG_D, BWD_THREADS,
                                                    BWD_WIDE_CTAS_PER_SM,
                                                    BWD_WIDE_ELEMS,
                                                    BWD_WIDE_THREADS,
                                                    MAX_BWD_D,
                                                    rmsnorm_bwd_plan)
    p = rmsnorm_bwd_plan(rows, d, itemsize, 132)
    threads, ctas = ((BWD_WIDE_THREADS, BWD_WIDE_CTAS_PER_SM) if d > BWD_LONG_D
                     else (BWD_THREADS, BWD_LONG_CTAS_PER_SM))
    assert p == (vecs, threads, 1, min(rows, ctas * 132))
    nvec = d * itemsize // 16
    assert vecs * threads >= nvec > 512 and d <= MAX_BWD_D
    if d > BWD_LONG_D:
        assert vecs * 16 // itemsize == BWD_WIDE_ELEMS


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_bwd_refuses_rows_past_16384(dtype):
    """d 16392 (16384 and one more 16-byte vector) has no backward kernel:
    the plan and the wrapper refuse it before any launch, with no plain
    version behind them; 16384 itself is planned."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    from repro_torch.kernels.rmsnorm.kernel import MAX_BWD_D, rmsnorm_bwd_plan
    assert MAX_BWD_D == 16384
    size = torch.finfo(dtype).bits // 8
    assert rmsnorm_bwd_plan(4, 16384, size).lanes == 512
    with pytest.raises(ValueError, match="16392"):
        rmsnorm_bwd_plan(4, 16392, size)
    x = torch.ones(2, 16392, dtype=dtype)
    w = torch.ones(16392, dtype=dtype)
    before = rmsnorm_bwd_cuda.launches
    with pytest.raises(ValueError, match="at most 16384"):
        rmsnorm_bwd_cuda(x, w, x)
    assert rmsnorm_bwd_cuda.launches == before
