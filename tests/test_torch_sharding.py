"""The port's sharding layer (``repro_torch.sharding``, ``launch.mesh``) and
the steps that run through a mesh, on the CPU.

* The JAX package's own sharding tests (tests/test_sharding.py) on the
  port's rules, context and local mesh, bounds unchanged.
* Cross-package: ``apply_rules`` gives the reference's spec for every leaf
  of ``build_specs`` of every config, on the local mesh and both production
  mesh shapes, under the default rules and every variant, and for the
  decode state's ``CACHE_AXES`` and the batch's names; the variants' tables
  are the reference's; ``tree_axes``, ``decode_state_structs`` and
  ``batch_structs`` match the reference's in shape and dtype.  Both
  packages read the mesh through a stand-in whose ``shape`` is the dict of
  axis sizes.
* Production meshes (torch's fake process group, in a subprocess each):
  axis names and sizes, DTensor placements and shard shapes, ``constrain``
  redistributing a DTensor, a checkpoint restored onto the mesh.
* Steps through a one-device mesh: prefill, decode and train steps equal
  the unmeshed steps' bit for bit; a reduced qwen3-1.7b trains through a
  1x1 mesh as JAX's ``make_train_step`` does on ``make_local_mesh()`` (loss
  and grad norm at 1e-4, params at 1e-3 of each leaf's largest magnitude,
  as in test_torch_train.py); tests/test_system.py's mesh case trains
  through the port's cache; a checkpoint restored with shardings gives the
  same bits; a mesh of more than one device without ranks refuses to
  execute (real ranks: tests/test_torch_multirank.py).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import CONFIGS, SHAPES, get_config, reduced_config
from repro_torch.launch.mesh import make_local_mesh, release_local_mesh
from repro_torch.launch.variants import apply_variant
from repro_torch.models.params import (p, tree_abstract, tree_axes,
                                       tree_init, tree_leaves)
from repro_torch.models.transformer import (build_specs, init_decode_state,
                                            init_params)
from repro_torch.serve.serve_step import (CACHE_AXES, decode_state_shardings,
                                          decode_state_structs, make_prefill,
                                          make_serve_step)
from repro_torch.sharding import DEFAULT_RULES, apply_rules, shardings_for
from repro_torch.sharding.context import constrain, sharding_ctx
from repro_torch.sharding.rules import (NamedSharding, P, logical_sharding,
                                        mesh_axes)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, AdamWState, init_state
from repro_torch.train.train_step import (batch_shardings, batch_structs,
                                          make_train_step)

from conftest import requires_mesh_axis_types

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("baseline", "fsdp_pod", "no_fsdp", "seq_shard", "expert_data",
            "vocab_data", "cache_seq_model", "pure_fsdp", "embed_replicated",
            "decode_weights_stationary", "ep_capacity", "ep_only",
            "batch_dp")
MESHES = {"local": {"data": 1, "model": 1},
          "pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}
# the reference's batch_shardings names
BATCH_NAMES = {"labels": ("batch", "seq"), "tokens": ("batch", "seq"),
               "inputs_embeds": ("batch", "seq", "act_embed"),
               "img_embeds": ("batch", "seq", "act_embed")}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def local_mesh():
    """The 1x1 CPU mesh (a one-rank gloo group), released after the
    module."""
    mesh = make_local_mesh("cpu")
    yield mesh
    release_local_mesh(mesh)


class StandIn:
    """A mesh as the reference's rules read one: ``shape`` a dict of axis
    sizes (a JAX mesh's ``shape`` is one)."""

    def __init__(self, shape):
        self.shape = dict(shape)


# ---------------------------------------------------------------------------
# tests/test_sharding.py on the port
# ---------------------------------------------------------------------------

def test_apply_rules_local_mesh_all_replicated_when_indivisible(local_mesh):
    mesh = local_mesh
    spec = apply_rules(("embed", "heads"), (7, 13), mesh)
    # axes of size 1 divide everything; spec may name them — sizes are 1
    for s in spec:
        if s is not None:
            assert all(mesh_axes(mesh)[a] == 1 for a in
                       ((s,) if isinstance(s, str) else s))


def test_divisibility_fallback(local_mesh):
    # dim 6 % 4 != 0 on a 4-wide axis → dropped; emulate via fake shape calc
    spec = apply_rules(("kv_heads",), (6,), local_mesh)
    assert isinstance(spec, P)
    assert apply_rules(("kv_heads",), (6,),
                       StandIn({"data": 1, "model": 4})) == P(None)
    assert apply_rules(("kv_heads",), (8,),
                       StandIn({"data": 1, "model": 4})) == P("model")


def test_duplicate_axis_not_reused(local_mesh):
    spec = apply_rules(("heads", "act_heads"), (4, 4), local_mesh)
    named = [s for s in spec if s is not None]
    flat = []
    for s in named:
        flat.extend((s,) if isinstance(s, str) else s)
    assert len(flat) == len(set(flat))


def test_shardings_for_paramspec_tree(local_mesh):
    specs = {"w": p((8, 16), ("embed", "ffn")),
             "b": p((16,), ("ffn",), init="zeros")}
    sh = shardings_for(specs, local_mesh)
    assert sh["w"].mesh == local_mesh


def test_constrain_noop_outside_ctx():
    x = torch.ones((4, 4))
    y = constrain(x, ("batch", "act_embed"))
    assert (y == x).all()


def test_constrain_inside_ctx(local_mesh):
    x = torch.ones((4, 4))
    with sharding_ctx(local_mesh, None):
        y = constrain(x, ("batch", "act_embed"))
    assert (y == x).all()


def test_tree_init_matches_abstract():
    specs = {"w": p((4, 6), ("embed", "ffn")),
             "n": p((6,), ("norm",), init="ones")}
    ab = tree_abstract(specs)
    real = tree_init(specs, torch.Generator().manual_seed(0))
    assert ab["w"].shape == real["w"].shape
    assert ab["w"].dtype == real["w"].dtype
    assert float(real["n"].sum()) == 6.0


# ---------------------------------------------------------------------------
# the port's own: meshes, placements, the context
# ---------------------------------------------------------------------------

def test_local_mesh_axes_and_group(local_mesh):
    import torch.distributed as dist
    assert mesh_axes(local_mesh) == {"data": 1, "model": 1}
    assert local_mesh.device_type == "cpu"
    again = make_local_mesh("cpu")          # reuses the fixture's group
    assert mesh_axes(again) == mesh_axes(local_mesh)
    assert not release_local_mesh(again)    # ... and leaves it alone
    assert dist.is_initialized()


def test_placements_and_shard_shape():
    mesh = StandIn(MESHES["multi_pod"])
    from torch.distributed.tensor import Replicate, Shard
    sh = logical_sharding(("batch", "seq", "act_embed"), (256, 4096, 2048),
                          mesh)
    assert sh.spec == P(("pod", "data"), None, None)
    assert sh.placements == (Shard(0), Shard(0), Replicate())
    assert sh.shard_shape((256, 4096, 2048)) == (8, 4096, 2048)
    w = logical_sharding(("embed", "heads"), (2048, 2048), mesh)
    assert w.placements == (Replicate(), Shard(0), Shard(1))
    assert w.shard_shape((2048, 2048)) == (128, 128)
    with pytest.raises(TypeError, match="not a mesh"):
        mesh_axes(object())


@pytest.mark.parametrize("build", ["train", "prefill", "serve", "constrain"])
def test_mesh_of_many_devices_refuses(build):
    """A mesh of more than one device without ranks (a stand-in) executes
    nothing: the builders refuse it, saying so; ``constrain`` refuses a
    plain tensor under any mesh of more than one device (a step's inputs
    arrive as DTensors; tests/test_torch_multirank.py runs real ranks)."""
    cfg = reduced_config("qwen3-1.7b")
    mesh = StandIn(MESHES["pod"])
    call = {"train": lambda: make_train_step(cfg, AdamWConfig(), mesh),
            "prefill": lambda: make_prefill(cfg, mesh, DEFAULT_RULES),
            "serve": lambda: make_serve_step(cfg, mesh, DEFAULT_RULES)}
    if build == "constrain":
        with pytest.raises(TypeError, match="arrive as DTensors"):
            with sharding_ctx(mesh, DEFAULT_RULES):
                constrain(torch.ones(32, 4, 8), ("batch", "seq", "act_embed"))
    else:
        with pytest.raises(NotImplementedError,
                           match="without ranks .*StandIn.* executes "
                                 "nothing"):
            call[build]()


@pytest.mark.parametrize("build", ["train", "prefill", "serve"])
@pytest.mark.parametrize("where", [None, "cpu"])
def test_rules_without_a_mesh_refuse(build, where):
    """Rules with no mesh to apply them to raise instead of being dropped;
    without rules a device in the mesh's place builds the unmeshed step."""
    cfg = reduced_config("qwen3-1.7b")
    call = {"train": lambda r: make_train_step(cfg, AdamWConfig(), where, r),
            "prefill": lambda r: make_prefill(cfg, where, r),
            "serve": lambda r: make_serve_step(cfg, where, r)}
    with pytest.raises(ValueError, match="rules without a mesh"):
        call[build](DEFAULT_RULES)
    if where == "cpu" or build == "train":
        assert callable(call[build](None))


_PRODUCTION = r"""
import json, sys, tempfile
import torch
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.sharding import DEFAULT_RULES, constrain, sharding_ctx
from repro_torch.sharding.rules import logical_sharding, mesh_axes
from repro_torch.train.checkpoint import CheckpointManager
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

multi = sys.argv[1] == "multi_pod"
mesh = make_production_mesh(multi_pod=multi)
out = {"axes": mesh_axes(mesh), "device_type": mesh.device_type}
names = ("batch", "seq", "act_embed")
x = distribute_tensor(torch.randn(64, 8, 32), mesh,
                      [Replicate()] * mesh.ndim)
with sharding_ctx(mesh, DEFAULT_RULES):
    y = constrain(x, names)
want = logical_sharding(names, (64, 8, 32), mesh)
out["constrain"] = [isinstance(y, DTensor), list(map(repr, y.placements)),
                    list(y.to_local().shape),
                    y.placements == want.placements,
                    list(want.shard_shape((64, 8, 32)))]
tree = {"w": torch.randn(64, 32), "n": torch.ones(32)}
axes = {"w": ("embed", "heads"), "n": ("norm",)}
sh = {k: logical_sharding(axes[k], tuple(v.shape), mesh)
      for k, v in tree.items()}
with tempfile.TemporaryDirectory() as d:
    ck = CheckpointManager(d)
    ck.save(1, tree)
    got, _ = ck.restore(tree, shardings=sh)
out["restore"] = {k: [list(map(repr, v.placements)), list(v.to_local().shape),
                      list(v.shape)] for k, v in got.items()}
try:
    make_local_mesh("cpu")
    out["local_after_production"] = "built"
except RuntimeError as e:
    out["local_after_production"] = str(e)
print("RESULT", json.dumps(out))
"""


def _subprocess(code, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=240,
                         env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("which", ["pod", "multi_pod"])
def test_production_mesh_places_and_constrains(which):
    """The (16, 16) and (2, 16, 16) meshes over the fake process group:
    the reference's axis names and sizes; ``constrain`` redistributes a
    replicated DTensor to the rules' placements (batch over pod and
    data); a checkpoint restores onto the mesh as DTensors of the
    shardings' placements; a local mesh cannot follow in that process."""
    got = _subprocess(_PRODUCTION, which)
    assert got["axes"] == MESHES[which]
    assert got["device_type"] == "cpu"
    n = len(MESHES[which])
    batch = (["Shard(dim=0)"] * (n - 1)) + ["Replicate()"]
    dp = 32 if which == "multi_pod" else 16
    assert got["constrain"] == [True, batch, [64 // dp, 8, 32], True,
                                [64 // dp, 8, 32]]
    w = (["Replicate()"] if which == "multi_pod" else []) + \
        ["Shard(dim=0)", "Shard(dim=1)"]
    assert got["restore"]["w"] == [w, [4, 2], [64, 32]]
    assert got["restore"]["n"] == [["Replicate()"] * n, [32], [32]]
    assert "fake" in got["local_after_production"]


def test_production_mesh_refused_after_a_local_one():
    got = _subprocess(
        "import json\n"
        "from repro_torch.launch.mesh import (make_local_mesh,\n"
        "                                     make_production_mesh)\n"
        "make_local_mesh('cpu')\n"
        "try:\n"
        "    make_production_mesh()\n"
        "    msg = 'built'\n"
        "except RuntimeError as e:\n"
        "    msg = str(e)\n"
        "print('RESULT', json.dumps(msg))\n")
    assert "gloo" in got and "process of its own" in got


# ---------------------------------------------------------------------------
# cross-package: rules, variants, structs
# ---------------------------------------------------------------------------

def _ref():
    """The reference's rules, variants and structs (modules that need JAX
    only for arrays and ShapeDtypeStructs)."""
    from repro.launch import variants as rv
    from repro.models import transformer as rt
    from repro.serve import serve_step as rs
    from repro.sharding import rules as rr
    from repro.train import train_step as rts
    from repro.configs import get_config as rget
    return rv, rt, rs, rr, rts, rget


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_apply_rules_matches_reference(arch):
    """Every leaf of ``build_specs``, the decode state under ``CACHE_AXES``
    at every serving shape, and the batch's names at every shape: the
    port's spec is the reference's, on each mesh shape under each
    variant's rules."""
    rv, rt, rs, rr, rts, rget = _ref()
    cfg, rcfg = get_config(arch), rget(arch)
    mine = list(tree_leaves(build_specs(cfg)))
    theirs = dict(tree_leaves(rt.build_specs(rcfg)))
    assert sorted(k for k, _ in mine) == sorted(theirs)
    states = {s: (decode_state_structs(cfg, SHAPES[s]),
                  rs.decode_state_structs(rcfg, SHAPES[s]))
              for s in ("decode_32k", "long_500k")}
    batches = {s: (batch_structs(cfg, SHAPES[s]),
                   rts.batch_structs(rcfg, SHAPES[s])) for s in SHAPES}
    assert CACHE_AXES == rs.CACHE_AXES
    checked = 0
    for variant in VARIANTS:
        rules = apply_variant(dict(DEFAULT_RULES), arch, "train_4k", variant)
        rrules = rv.apply_variant(dict(rr.DEFAULT_RULES), arch, "train_4k",
                                  variant)
        assert rules == rrules
        for shape in MESHES.values():
            mesh = StandIn(shape)
            for path, s in mine:
                r = theirs[path]
                assert apply_rules(s.axes, s.shape, mesh, rules) == \
                    tuple(rr.apply_rules(r.axes, r.shape, mesh, rrules)), \
                    (path, variant, shape)
                checked += 1
            for s, (st, rst) in states.items():
                for k, v in st.items():
                    pairs = zip(v, rst[k]) if k == "img_kv" else [(v, rst[k])]
                    for a, b in pairs:
                        assert apply_rules(CACHE_AXES[k], a.shape, mesh,
                                           rules) == tuple(rr.apply_rules(
                                               rs.CACHE_AXES[k], b.shape,
                                               mesh, rrules)), (k, s)
                        checked += 1
                got = decode_state_shardings(cfg, SHAPES[s], mesh, rules)
                assert got["pos"].spec == P()
            for s, (bt, rbt) in batches.items():
                got = batch_shardings(cfg, SHAPES[s], mesh, rules)
                assert sorted(got) == sorted(rbt)
                for k, sh in got.items():
                    assert sh.spec == tuple(rr.apply_rules(
                        BATCH_NAMES[k], rbt[k].shape, mesh, rrules))
                    checked += 1
    assert checked > len(VARIANTS) * len(MESHES) * len(mine)


def _dtype(d):
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_structs_match_reference(arch):
    """``tree_axes`` of the specs, ``decode_state_structs`` and
    ``batch_structs`` at every shape: the reference's axes, shapes and
    dtypes."""
    rv, rt, rs, rr, rts, rget = _ref()
    from repro.models.params import tree_axes as rtree_axes
    cfg, rcfg = get_config(arch), rget(arch)
    assert dict(tree_leaves(tree_axes(build_specs(cfg)))) == \
        dict(tree_leaves(rtree_axes(rt.build_specs(rcfg))))
    for s in SHAPES.values():
        for mine, theirs in ((decode_state_structs(cfg, s),
                              rs.decode_state_structs(rcfg, s)),
                             (batch_structs(cfg, s),
                              rts.batch_structs(rcfg, s))):
            assert sorted(mine) == sorted(theirs)
            for k, v in mine.items():
                pairs = zip(v, theirs[k]) if isinstance(v, tuple) \
                    else [(v, theirs[k])]
                for a, b in pairs:
                    assert a.device.type == "meta"
                    assert (tuple(a.shape), _dtype(a.dtype)) == \
                        (tuple(b.shape), str(b.dtype)), (arch, s.name, k)


# ---------------------------------------------------------------------------
# steps through a one-device mesh
# ---------------------------------------------------------------------------

def test_mesh_steps_equal_unmeshed_bitwise(local_mesh):
    """Prefill, 3 decode steps and 2 train steps of a reduced qwen3-1.7b
    through the 1x1 mesh under ``DEFAULT_RULES``: the unmeshed steps'
    logits, loss and params, bit for bit."""
    cfg = reduced_config("qwen3-1.7b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))

    def fresh():
        return init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = fresh()
    runs = {}
    for name, where, rules in (("mesh", local_mesh, DEFAULT_RULES),
                               ("plain", "cpu", None)):
        out = [make_prefill(cfg, where, rules)(params, toks[:, :16])]
        state = init_decode_state(cfg, 2, 8, device="cpu")
        step = make_serve_step(cfg, where, rules)
        for i in range(3):
            logits, state = step(params, state, toks[:, i:i + 1])
            out.append(logits)
        p = fresh()
        o = init_state(p)
        train = make_train_step(cfg, AdamWConfig(lr=1e-2), where, rules,
                                remat="full")
        for _ in range(2):
            p, o, m = train(p, o, {"tokens": toks[:, :16],
                                   "labels": toks[:, 1:]})
            out.append(m["loss"])
        out.extend(t for _, t in tree_leaves(p))
        runs[name] = out
    assert len(runs["mesh"]) == len(runs["plain"])
    for a, b in zip(runs["mesh"], runs["plain"]):
        assert torch.equal(a, b)


def test_checkpoint_restore_with_shardings(local_mesh, tmp_path):
    """Params and AdamW state restored with ``shardings_for`` the specs on
    the 1x1 mesh: plain tensors on the mesh's device, the saved bits."""
    cfg = reduced_config("qwen3-1.7b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_state(params)
    ck = CheckpointManager(tmp_path)
    ck.save(3, (params, opt), {"step": 3})
    psh = shardings_for(build_specs(cfg), local_mesh, DEFAULT_RULES)
    sh = (psh, AdamWState(NamedSharding(local_mesh, P()), psh, psh))
    like = (params, opt)
    (got, gopt), extra = ck.restore(like, shardings=sh)
    assert extra == {"step": 3}
    for (path, a), (_, b) in zip(tree_leaves(got), tree_leaves(params)):
        assert type(a) is torch.Tensor and a.dtype == b.dtype
        assert torch.equal(a, b), path
    assert int(gopt.step) == 0
    with pytest.raises(ValueError, match="shardings have"):
        ck.restore(like, shardings=(psh,))


@requires_mesh_axis_types
def test_train_step_through_mesh_matches_jax(local_mesh):
    """A reduced qwen3-1.7b, 4 steps through the 1x1 mesh against JAX's
    ``make_train_step`` on its ``make_local_mesh()``: loss and grad norm
    of every step at 1e-4, the final params at 1e-3 of each leaf's
    largest magnitude (test_torch_train.py's tolerances)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.launch.mesh import make_local_mesh as jax_local_mesh
    from repro.models import transformer as jt
    from repro.train import optimizer as jopt
    from repro.train.train_step import make_train_step as jax_train_step
    from repro_torch.interop import params_from_jax
    jcfg = jax_reduced_config("qwen3-1.7b")
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jt.init_params(jcfg, jax.random.PRNGKey(0)))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=4)
    jstep = jax.jit(jax_train_step(jcfg, jopt.AdamWConfig(**kw),
                                   jax_local_mesh(), None, remat="none"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tstep = make_train_step(reduced_config("qwen3-1.7b"), AdamWConfig(**kw),
                            local_mesh, DEFAULT_RULES, remat="full")
    js, ts = jopt.init_state(jp), init_state(tp)
    for i in range(4):
        toks = np.random.default_rng(10 + i).integers(0, jcfg.vocab, (4, 17))
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       atol=1e-4, rtol=1e-4)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, t in tree_leaves(tp):
        w = np.asarray(want[path], np.float32)
        err = float(np.abs(t.numpy() - w).max())
        assert err <= 1e-3 * max(float(np.abs(w).max()), 1e-30), path


def test_pipeline_trains_through_cache(local_mesh):
    """tests/test_system.py's mesh case on the port: a reduced qwen3-1.7b
    trains 12 steps through the 1x1 CPU mesh on batches that
    ``CachedTokenPipeline`` reads through the port's IGTCache, and
    learns."""
    from repro_torch.core import CacheConfig, IGTCache
    from repro_torch.core.types import MB
    from repro_torch.data.pipeline import (CachedTokenPipeline,
                                           make_token_dataset)
    from repro_torch.storage import RemoteStore
    store = RemoteStore()
    store.add(make_token_dataset("corpus", n_shards=4, shard_bytes=8 * MB))
    ccfg = CacheConfig(min_share=2 * MB, rebalance_quantum=2 * MB,
                       rebalance_period=5.0, block_size=1 * MB)
    engine = IGTCache(store, 16 * MB, cfg=ccfg)
    cfg = reduced_config("qwen3-1.7b")
    pipe = CachedTokenPipeline(store, engine, "corpus", seq_len=32, batch=2,
                               vocab=cfg.vocab, background_prefetch=False)
    step = make_train_step(cfg, AdamWConfig(lr=5e-3, warmup_steps=2,
                                            total_steps=100),
                           local_mesh, None, remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_state(params)
    losses = []
    it = pipe.batches(epochs=3)
    for i, b in enumerate(it):
        if i >= 12:
            break
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]            # it learns something
    assert pipe.stats.batches >= 12
    pipe.close()
