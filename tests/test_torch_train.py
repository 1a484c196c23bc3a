"""The port's training path against the JAX package's, on the CPU: the
kernels' backward plain versions (and the autograd Functions' CPU path)
against ``jax.vjp`` of the references, the two losses, full-model gradients
of reduced qwen3-1.7b, mamba2-370m (ssm) and zamba2-1.2b (hybrid), remat,
AdamW, 8-step trajectories of ``make_train_step``, checkpoints crossing both
ways, and the launcher.  (The SSD chunk's own gradient:
tests/test_torch_ssd_train.py.)

Inputs are drawn with numpy from a seed; weights are JAX-initialised and
carried over by ``params_from_jax``.  Tolerances, all in f32: the kernels'
gradients at their forward tolerances (tests/test_kernels.py: RMSNorm 1e-5,
flash attention 5e-5); the losses at 1e-6; model gradients at 1e-4 of each
leaf's largest magnitude (the two frameworks sum the same products in other
orders); the trajectory's losses at 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention import ref as jax_fa
from repro.kernels.rmsnorm import ref as jax_rms
from repro.launch.mesh import make_local_mesh
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.rmsnorm import rmsnorm_bwd_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step

from conftest import requires_mesh_axis_types

ARCH = "qwen3-1.7b"


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """These small tensors run faster on two threads than on every core, and
    the test workers share the cores; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _leaf_close(got, want, tol=1e-4, what=""):
    """Within ``tol`` of the leaf's largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ----------------------------------------------------------- kernels

@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 16),
                                   (3, 12288), (2, 16384)])  # the widest rows
@pytest.mark.parametrize("path", ["ref", "function"])
def test_rmsnorm_backward_matches_jax_grad(shape, path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1])).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(jax_rms.rmsnorm_ref, x, w)
    jdx, jdw = vjp(dy)
    tx, tw, tdy = _t(x), _t(w), _t(dy)
    if path == "ref":
        dx, dw = rmsnorm_bwd_ref(tx, tw, tdy)
    else:
        tx.requires_grad_(True)
        tw.requires_grad_(True)
        dx, dw = torch.autograd.grad(rmsnorm(tx, tw), (tx, tw), tdy)
    _close(dx, jdx, 1e-5)
    _close(dw, jdw, 1e-5)


FLASH_CASES = {            # (B, Sq, Skv, H, KV, hd, causal, q_offset)
    "gqa": (2, 12, 12, 4, 2, 16, True, 0),
    "mqa_noncausal": (1, 6, 10, 4, 1, 16, False, 0),
    "q_offset": (2, 5, 12, 4, 2, 16, True, 7),
    "mha_hd32": (1, 9, 9, 2, 2, 32, True, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_jax_grad(case):
    B, Sq, Skv, H, KV, hd, causal, off = FLASH_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=causal, q_offset=off)
    jo, want = jax.jit(lambda q, k, v, do: (lambda o, vjp: (o, vjp(do)))(
        *jax.vjp(lambda q, k, v: jax_fa.flash_attention_ref(
            q, k, v, block_kv=8, **kw), q, k, v)))(q, k, v, do)
    tq, tk, tv, tdo = _t(q), _t(k), _t(v), _t(do)
    # The plain backward, from the plain forward's o and lse ...
    o, lse = flash_attention_ref(tq, tk, tv, block_kv=8, return_lse=True,
                                 **kw)
    _close(o, jo, 5e-5)
    for g, w in zip(flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw),
                    want):
        _close(g, w, 5e-5)
    # ... where lse is the log-sum-exp of the scaled, masked scores
    s = torch.einsum("bqhd,bkhd->bhqk", tq,
                     tk.repeat_interleave(H // KV, dim=2)) / hd ** 0.5
    if causal:
        qp = off + torch.arange(Sq)[:, None]
        s = s.masked_fill(qp < torch.arange(Skv)[None, :], -torch.inf)
    _close(lse, torch.logsumexp(s, -1), 1e-5)
    # ... and the autograd Function's CPU path.
    for t in (tq, tk, tv):
        t.requires_grad_(True)
    o = flash_attention(tq, tk, tv, block_kv=8, **kw)
    for g, w in zip(torch.autograd.grad(o, (tq, tk, tv), tdo), want):
        _close(g, w, 5e-5)


# ------------------------------------------------------------- losses

def test_lm_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5))
    jl, jg = jax.value_and_grad(jt.lm_loss)(logits, labels)
    tl = _t(logits).requires_grad_(True)
    loss = tt.lm_loss(tl, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(loss, tl)
    _close(loss.detach(), jl, 1e-6)
    _close(g, jg, 1e-6)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama3-405b"])  # tied, untied
def test_lm_loss_chunked_matches_jax_and_dense(arch):
    jcfg = jax_reduced_config(arch)
    cfg = dataclasses.replace(reduced_config(arch), vocab=37)
    jcfg = dataclasses.replace(jcfg, vocab=37)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    # only the head's leaf: an untied model's embed takes no part in the loss
    params = ({"embed": rng.normal(size=(37, cfg.d_model))}
              if cfg.tie_embeddings else
              {"lm_head": rng.normal(size=(cfg.d_model, 37))})
    params = {k: v.astype(np.float32) for k, v in params.items()}
    labels = rng.integers(0, 37, (2, 5))
    jl, (jgx, jgp) = jax.value_and_grad(
        lambda x, p: jt.lm_loss_chunked(x, p, jcfg, labels, vocab_chunk=16),
        argnums=(0, 1))(x, params)
    tx = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tl = torch.from_numpy(labels)
    loss = tt.lm_loss_chunked(tx, tp, cfg, tl, vocab_chunk=16)
    grads = torch.autograd.grad(loss, [tx, *tp.values()])
    _close(loss.detach(), jl, 1e-6)
    _close(grads[0], jgx, 1e-6)
    for g, k in zip(grads[1:], tp):
        _close(g, jgp[k], 1e-6)
    head = tp["embed"].T if cfg.tie_embeddings else tp["lm_head"]
    dense = tt.lm_loss(tx @ head, tl)
    _close(loss.detach(), dense.detach(), 1e-6)


# --------------------------------------------------------------- model

def _perturb(tree, rng):
    """Norm weights (and an SSM layer's D, A_log and dt_bias) drawn from
    numpy, so that they are not the init's ones and zeros."""
    out = dict(tree)
    for name in tree:
        if name.endswith("norm") or name == "D":
            out[name] = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=tree[name].shape), jnp.bfloat16)
        elif name in ("A_log", "dt_bias"):
            out[name] = jnp.asarray(0.5 * rng.normal(size=tree[name].shape),
                                    jnp.bfloat16)
    return out


def _jax_params(dtype=jnp.float32, arch=ARCH):
    """JAX init with norm weights perturbed from numpy (not all ones)."""
    cfg = jax_reduced_config(arch)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    params = dict(params, blocks=_perturb(params["blocks"], rng),
                  final_norm=jnp.asarray(1.0 + 0.1 * rng.normal(
                      size=params["final_norm"].shape), jnp.bfloat16))
    if "shared" in params:
        params["shared"] = _perturb(params["shared"], rng)
    return cfg, jax.tree.map(lambda a: a.astype(dtype), params)


# S for the ssm / hybrid models: two of the reduced configs' 32-step
# chunks, the second padded.
SSM_SEQ = 40
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")


def _seq(arch):
    return SSM_SEQ if arch in SSM_ARCHS else 16


def _batch(vocab, B=4, S=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _value_and_grad(params, cfg, batch, remat="none", loss_impl="dense"):
    paths, leaves = zip(*tree_leaves(params))
    req = [t.detach().clone().requires_grad_(True) for t in leaves]
    tree = tree_unflatten(zip(paths, req))
    tb = _torch_batch(batch)
    out, _ = tt.forward(tree, cfg, tb["tokens"], remat=remat,
                        return_hidden=loss_impl == "chunked")
    if loss_impl == "chunked":
        loss = tt.lm_loss_chunked(out, tree, cfg, tb["labels"])
    else:
        loss = tt.lm_loss(out, tb["labels"])
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, req)))


@pytest.mark.parametrize("arch,loss_impl", [
    pytest.param(ARCH, "dense", id="dense"),
    pytest.param(ARCH, "chunked", id="chunked"),
    *(pytest.param(a, impl, id=f"{a}-{impl}") for a in SSM_ARCHS
      for impl in ("dense", "chunked"))])
def test_model_gradients_match_jax(arch, loss_impl):
    jcfg, jp = _jax_params(arch=arch)
    cfg = reduced_config(arch)
    batch = _batch(cfg.vocab, S=_seq(arch))

    def jloss(p):
        if loss_impl == "chunked":
            h, _ = jt.forward(p, jcfg, batch["tokens"], remat="none",
                              return_hidden=True)
            return jt.lm_loss_chunked(h, p, jcfg, batch["labels"])
        logits, _ = jt.forward(p, jcfg, batch["tokens"], remat="none")
        return jt.lm_loss(logits, batch["labels"])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    loss, grads = _value_and_grad(tp, cfg, batch, loss_impl=loss_impl)
    _close(loss, jl, 1e-5)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jg)))
    assert sorted(jflat) == sorted(grads)
    for path, g in grads.items():
        _leaf_close(g, jflat[path], 1e-4, path)


def test_remat_policies_give_identical_grads():
    _check_remat_identity(ARCH)


def test_remat_policies_give_identical_grads_ssm():
    """The same for mamba2-370m: the SSD, the conv and the gated norm
    recomputed under "full" and "dots"."""
    _check_remat_identity("mamba2-370m")


def _check_remat_identity(arch):
    _, jp = _jax_params(arch=arch)
    cfg = reduced_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = _batch(cfg.vocab, S=_seq(arch), seed=4)
    base_loss, base = _value_and_grad(tp, cfg, batch, remat="none")
    for remat in ("full", "dots"):
        loss, grads = _value_and_grad(tp, cfg, batch, remat=remat)
        assert torch.equal(loss, base_loss), remat
        for path, g in grads.items():
            assert torch.equal(g, base[path]), (remat, path)
    with pytest.raises(ValueError, match="remat"):
        _value_and_grad(tp, cfg, batch, remat="some")


def test_other_families_refuse_to_train():
    """ssm, hybrid, moe, vlm and audio build an unmeshed step and, on a
    mesh of more than one device, reach the mesh's own check: a stand-in
    without ranks refuses them as it refuses a dense model (real ranks:
    tests/test_torch_multirank_ssm.py, tests/test_torch_multirank.py,
    tests/test_torch_multirank_moe.py and
    tests/test_torch_multirank_vlm_audio.py; one-device meshes:
    tests/test_torch_sharding.py)."""
    class Mesh:                     # a mesh as the rules read one
        shape = {"data": 16, "model": 16}
    for arch in SSM_ARCHS + ("granite-moe-3b-a800m", "llama-3.2-vision-90b",
                             "musicgen-large"):
        assert callable(make_train_step(reduced_config(arch),
                                        topt.AdamWConfig()))
        with pytest.raises(NotImplementedError, match="without ranks"):
            make_train_step(reduced_config(arch), topt.AdamWConfig(),
                            mesh=Mesh())
    with pytest.raises(NotImplementedError, match="without ranks"):
        make_train_step(reduced_config(ARCH), topt.AdamWConfig(),
                        mesh=Mesh())


# ----------------------------------------------------------- optimizer

def test_apply_updates_matches_jax_on_the_quadratic():
    """tests/test_train.py's quadratic, step by step against JAX."""
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                           weight_decay=0.0, grad_clip=10.0)
    jupd = jax.jit(jopt.apply_updates, static_argnums=3)
    jp = {"w": jnp.asarray([3.0, -2.0])}
    js = jopt.init_state(jp)
    tp = {"w": torch.tensor([3.0, -2.0])}
    ts = topt.init_state(tp)
    for _ in range(150):
        jp, js, jm = jupd(jp, {"w": 2 * jp["w"]}, js, cfg)
        tp, ts, tm = topt.apply_updates(tp, {"w": 2 * tp["w"]}, ts, cfg)
    _close(tp["w"], jp["w"], 1e-5)
    _close(tm["lr"], jm["lr"], 1e-7)
    assert int(ts.step) == int(js.step) == 150
    assert float(tp["w"].abs().max()) < 0.15
    # schedule, clipping (grad_norm reported before the clip) and int8
    # compression as in JAX
    for s in (0, 1, 50, 150, 250):
        _close(topt.schedule(cfg, torch.tensor(s)),
               jopt.schedule(cfg, jnp.asarray(s)), 1e-7)
    g = {"a": torch.tensor([1e6, -3.0, 0.5]), "b": torch.tensor([[2.0]])}
    ref = jopt.compress_grads({k: jnp.asarray(v.numpy()) for k, v in
                               g.items()}, "int8")
    got = topt.compress_grads(g, "int8")
    for k in g:
        _close(got[k], ref[k], 1e-6)
    _, _, m = topt.apply_updates({"w": torch.zeros(4)},
                                 {"w": torch.full((4,), 1e6)},
                                 topt.init_state({"w": torch.zeros(4)}),
                                 topt.AdamWConfig(grad_clip=1.0))
    assert float(m["grad_norm"]) > 1e6


@requires_mesh_axis_types
@pytest.mark.parametrize("arch,microbatches", [
    pytest.param(ARCH, 1, id="1"), pytest.param(ARCH, 2, id="2"),
    pytest.param("zamba2-1.2b", 1, id="zamba2-1.2b-1")])
def test_adamw_trajectory_matches_jax_train_step(arch, microbatches):
    """8 steps of ``make_train_step`` against the JAX package's: loss and
    grad norm of every step at 1e-4, the final params at 1e-3 of each
    leaf's largest magnitude.  qwen3 runs free.  zamba2 starts every step
    from JAX's params and AdamW state: free-running, the two 8-step
    trajectories of the reduced hybrid drift apart however right each step
    is (step 0's grad norms agree to 1.8e-7, step 5's differ by 1.3e-4,
    and by 9e-5 with AdamW's eps at 1e-6), so each step is held from the
    same state instead."""
    jcfg, jp = _jax_params(arch=arch)
    cfg = reduced_config(arch)
    opt = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8)
    jstep = jax.jit(jax_make_train_step(
        jcfg, jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8),
        make_local_mesh(), None, remat="none", microbatches=microbatches))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tstep = make_train_step(cfg, opt, remat="full", microbatches=microbatches)
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for i in range(8):
        batch = _batch(cfg.vocab, S=_seq(arch), seed=10 + i)
        if arch != ARCH:
            tp, mu, nu = (params_from_jax(jax.tree.map(np.asarray, t), "cpu")
                          for t in (jp, js.mu, js.nu))
            ts = topt.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                                 mu, nu)
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, _torch_batch(batch))
        _close(tm["loss"], jm["loss"], 1e-4)
        _close(tm["grad_norm"], jm["grad_norm"], 1e-4)
    jflat = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(tp):
        _leaf_close(t, jflat[path], 1e-3, path)


# ---------------------------------------------------------- checkpoint

def test_checkpoints_cross_both_ways(tmp_path):
    """bf16 params + f32 moments + the int32 step: written by one package,
    restored by the other, bit for bit, under the same manifest keys."""
    _check_checkpoints_cross(tmp_path, ARCH)


def test_checkpoints_cross_both_ways_hybrid(tmp_path):
    """The same for zamba2-1.2b, whose ``shared`` leaves have no layer
    dim."""
    _check_checkpoints_cross(tmp_path, "zamba2-1.2b")


def _check_checkpoints_cross(tmp_path, arch):
    _, jp = _jax_params(jnp.bfloat16, arch=arch)
    js = jopt.init_state(jp)
    rng = np.random.default_rng(5)
    js = jopt.AdamWState(jnp.asarray(7, jnp.int32), jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), js.mu),
        js.nu)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = topt.init_state(tp)

    JaxCheckpointManager(tmp_path / "jax").save(3, (jp, js), {"step": 3})
    (rp, rs), extra = CheckpointManager(tmp_path / "jax").restore((tp, ts))
    assert extra == {"step": 3} and int(rs.step) == 7
    assert rs.step.dtype == torch.int32
    for (path, t), (_, a) in zip(tree_leaves(rp),
                                 tree_leaves(jax.tree.map(np.asarray, jp))):
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))
    for (_, t), (_, a) in zip(tree_leaves(rs.mu), tree_leaves(js.mu)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))

    mgr = CheckpointManager(tmp_path / "torch", keep=2)
    for step in (1, 2, 3):
        mgr.save_async(step, (rp, rs), {"step": step})
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()
                  if p.name.startswith("step_")) == ["step_00000002",
                                                     "step_00000003"]
    (bp, bs), extra = JaxCheckpointManager(tmp_path / "torch").restore(
        (jp, jopt.init_state(jp)))
    assert extra == {"step": 3} and int(bs.step) == 7
    for a, b in zip(jax.tree.leaves((bp, bs)), jax.tree.leaves((jp, js))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    import json
    keys = [[leaf["key"] for leaf in json.loads(
        (tmp_path / d / "manifest.json").read_text())["leaves"]]
        for d in ("jax/step_00000003", "torch/step_00000003")]
    assert keys[0] == keys[1]


# ------------------------------------------------------------ launcher

def test_launcher_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--cache-mb", "64", "--ckpt-dir", str(tmp_path),
            "--log-every", "2", "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[train] step     4" in out and "CHR" in out
    assert CheckpointManager(tmp_path).latest_step() == 4
    assert launch_train.main(args + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "2 steps" in out
    assert CheckpointManager(tmp_path).latest_step() == 6


def test_launcher_trains_hybrid_and_resumes_on_cpu(tmp_path, capsys):
    """The launcher on reduced zamba2-1.2b: the SSD's gradient reaches the
    step, and a resume restores the Mamba2 stacks and the shared block."""
    arch = "zamba2-1.2b"
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "40", "--cache-mb", "64", "--ckpt-dir", str(tmp_path),
            "--log-every", "2", "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[train] step     4" in out and "CHR" in out
    assert launch_train.main(args + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "2 steps" in out
    params = tt.init_params(reduced_config(arch),
                            torch.Generator().manual_seed(0))
    (restored, state), extra = CheckpointManager(tmp_path).restore(
        (params, topt.init_state(params)))
    assert extra == {"step": 6} and int(state.step) == 6
    for leaf in (restored["blocks"]["in_proj"], restored["blocks"]["A_log"],
                 restored["shared"]["wq"]):
        assert bool(torch.isfinite(leaf.float()).all())
    assert not torch.equal(restored["blocks"]["A_log"],
                           params["blocks"]["A_log"])
    assert not torch.equal(restored["shared"]["wq"], params["shared"]["wq"])


def test_launcher_trains_moe_and_resumes_on_cpu(tmp_path, capsys):
    """The same launcher on a reduced MoE model (granite-moe-3b-a800m):
    the aux loss reaches the step, and a resume restores the expert
    stacks."""
    args = ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--cache-mb", "64",
            "--ckpt-dir", str(tmp_path), "--log-every", "2",
            "--ckpt-every", "2"]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[train] step     4" in out and "CHR" in out
    assert launch_train.main(args + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "2 steps" in out
    assert CheckpointManager(tmp_path).latest_step() == 6
    cfg = reduced_config("granite-moe-3b-a800m")
    params = tt.init_params(cfg, torch.Generator().manual_seed(0))
    (restored, state), extra = CheckpointManager(tmp_path).restore(
        (params, topt.init_state(params)))
    assert extra == {"step": 6} and int(state.step) == 6
    assert not torch.equal(restored["blocks"]["w_down"],
                           params["blocks"]["w_down"])


# ------------------------------------------------- dispatch and plans

def test_cpu_backward_launches_nothing_and_wrappers_refuse_cpu():
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda
    before = (rmsnorm_bwd_cuda.launches, flash_attention_bwd_cuda.launches)
    x = torch.randn(3, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    rmsnorm(x, w).sum().backward()
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    flash_attention(q, q.detach(), q.detach()).sum().backward()
    assert (rmsnorm_bwd_cuda.launches,
            flash_attention_bwd_cuda.launches) == before
    assert x.grad is not None and q.grad is not None
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_bwd_cuda(x.detach(), w.detach(), x.detach())
    t = q.detach()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(t, t, t, t, torch.zeros(1, 2, 4), t)


def test_backward_launch_plans():
    """The plans mirror csrc's shared-memory structs and lane choices."""
    from repro_torch.kernels.flash_attention.kernel import bwd_plan
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_plan
    p = bwd_plan(torch.bfloat16, 128, 4, 1024, 8)
    assert (p.variant, p.block_q, p.block_kv, p.stages, p.threads, p.grid) == (
        "wgmma", 64, 128, 2, 384, (132, 1, 1))
    # K, V (128 x 128) + 2 slots of Q, dO (64 x 128) + 2 dS and two P (64
    # x 128: P and its rounding remainder) bf16; 2 dQ tiles (64 x 64 f32);
    # lse, D (2 x 64 f32); 6 barriers; alignment
    assert p.smem_bytes == (2 * (2 * 128 * 128 + 2 * 2 * 64 * 128
                                 + 4 * 64 * 128) + 4 * 2 * 64 * 64
                            + 8 * 2 * 64 + 6 * 8 + 1024) == 231472
    p = bwd_plan(torch.bfloat16, 16, 2, 40, 2)
    assert (p.variant, p.block_q, p.grid) == ("mma_sync", 64, (1, 2, 2))
    p = bwd_plan(torch.float32, 128, 2, 1601, 8)
    assert (p.variant, p.block_q, p.threads, p.grid) == (
        "fma", 64, 256, (26, 8, 2))
    assert p.smem_bytes == 4 * (4 * 64 * 129 + 64 * 65 + 128) <= 232448
    with pytest.raises(ValueError):
        bwd_plan(torch.bfloat16, 96, 1, 64, 1)
    # (vectors a thread, threads a row, rows a CTA, CTAs): d_model takes 128
    # threads of two vectors, two rows a CTA, on a grid of four CTAs an SM;
    # the head dim 16 threads, 16 rows a CTA
    assert rmsnorm_bwd_plan(4096, 2048, 2, 132) == (2, 128, 2, 528)
    assert rmsnorm_bwd_plan(40, 2048, 2, 132).grid == 20
    assert rmsnorm_bwd_plan(100, 128, 2, 132) == (1, 16, 16, 7)
    assert rmsnorm_bwd_plan(80, 16, 2, 132) == (1, 8, 32, 3)  # 32 rows a CTA


@pytest.mark.parametrize("rows,d,itemsize,sms", [
    (4096, 2048, 2, 132), (65536, 128, 2, 132), (32768, 128, 4, 132),
    (1000, 2048, 4, 132), (80, 64, 2, 132), (640, 16, 4, 132),
    (7, 4096, 2, 132), (100000, 1024, 2, 8), (1, 8, 2, 1)])
def test_rmsnorm_bwd_plan_mirrors_the_launch(rows, d, itemsize, sms):
    """The fewest threads a row (at least 8) that leave one vector each up
    to a warp, then two; the groups fill a CTA of 256 threads; one wave of
    at most four CTAs an SM, striding over every row."""
    from repro_torch.kernels.rmsnorm.kernel import (BWD_CTAS_PER_SM,
                                                    BWD_THREADS,
                                                    rmsnorm_bwd_plan)
    nvec = d * itemsize // 16
    p = rmsnorm_bwd_plan(rows, d, itemsize, sms)
    assert p.vecs * p.lanes >= nvec and p.lanes >= 8
    assert p.lanes == 8 or (p.vecs * p.lanes) // 2 < nvec
    assert p.vecs == (1 if nvec <= 32 else 2)
    assert p.groups * p.lanes == BWD_THREADS
    assert 1 <= p.grid <= BWD_CTAS_PER_SM * sms
    assert p.grid == min(-(-rows // p.groups), BWD_CTAS_PER_SM * sms)
    # every row falls to exactly one (CTA, group, trip)
    stride = p.grid * p.groups
    trips = -(-rows // stride)
    seen = sorted(g + t * stride for g in range(stride) for t in range(trips)
                  if g + t * stride < rows)
    assert seen == list(range(rows))
