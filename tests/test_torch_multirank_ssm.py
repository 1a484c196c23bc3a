"""Multi-rank execution of the ssm and hybrid families on four CPU ranks
(gloo), held against JAX's sharded steps on four forced host devices and
against the port's own unmeshed steps.

Reduced mamba2-370m (2 layers) and reduced zamba2-1.2b cut to 4 layers (its
weight-shared attention block fires at layers 0 and 2), both at d 64, d_in
128, 8 SSM heads of 16, state 16, chunk 32, in f32 from the reference's
seed-0 init, run through ``make_prefill``, ``make_serve_step`` and
``make_train_step`` on a ``DeviceMesh`` of four ranks under
``DEFAULT_RULES``:

* the (2, 2) ("data", "model") mesh: each rank holds 2 of the 4 sequences,
  4 of the 8 SSM heads, half of the conv channels and, in zamba2's shared
  block, 2 of the 4 q heads and 1 of the 2 KV heads;
* the (1, 4) mesh: 2 SSM heads and a quarter of the channels a rank; the 2
  KV heads do not divide by 4, so each rank's q head reads its group's.

The sequence is 48 tokens: one chunk of 32 and a padded one of 16.  The
decode state is random (bf16 conv and shared k / v, f32 SSD state, drawn
with numpy): zeros would hide a misplaced write.

Held: each rank's local shard of every param and decode-state leaf equals
JAX's addressable shard bit for bit; prefill and decode logits, losses and
grad norms at 1e-4 and the final params at 1e-3 of each leaf's largest
magnitude (but for the few elements whose AdamW step rounding decides,
``_held_params``) against JAX's sharded steps and the port's unmeshed
ones; the
SSD and conv boundaries' local operand shapes; a checkpoint written across
ranks restoring on one device; and the SSD boundary run around
``ssd_chunked(..., ssd_chunk)`` (the chunk's autograd Function with its
plain backward inside ``local_map``), its gradients against the unmeshed
ones; the collectives of the prefill, the first decode step and the first
train step on each rank equal, in calls and bytes by kind, the dry-run
twin's count of the same step lowered on that rank's mesh
(``Lowered.count``), and so do their FLOPs and bytes accessed, counted by
the same tally (``roofline.trace.RankTally``) on the same step, its inputs
placed before it as the twin's are; later steps take the global batch or
tokens, as a caller gives them, and place them themselves.

The ranks run in processes of their own (``launch.ranks.run_ranks``,
spawned, one torch thread each); the JAX side runs in a subprocess with four
forced host devices.  Both start together once for the module, under the
lock that ``tests/test_torch_multirank.py`` takes too, so that one group of
four ranks at a time loads the host.
"""
import contextlib
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import build_specs, init_decode_state
from repro_torch.serve.serve_step import make_prefill, make_serve_step
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = {"mamba2-370m": 2, "zamba2-1.2b": 4}      # arch -> layers
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, MAX_SEQ, POS0 = 4, 48, 16, 4     # decode starts at position POS0
DECODE_STEPS, TRAIN_STEPS = 3, 2
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
TOL, PARAM_TOL = 1e-4, 1e-3
CKPT_ARCH, CKPT_STEP = "zamba2-1.2b", 2
# the SSD boundary around the chunk kernel's autograd Function
SSD_SHAPE = dict(b=4, s=48, h=8, p=16, n=16, chunk=32)
LOCK = os.path.join(tempfile.gettempdir(), "repro_torch_multirank.lock")


@contextlib.contextmanager
def one_rank_group():
    """Hold the host-wide lock of the multi-rank test modules: one group of
    four ranks and one four-device JAX process at a time."""
    with open(LOCK, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def config(arch):
    return replace(reduced_config(arch), n_layers=ARCHS[arch])


def state_leaves(cfg) -> dict:
    """The decode state's tensor leaves: name -> (shape, dtype)."""
    st = init_decode_state(cfg, B, MAX_SEQ, device="meta")
    return {k: (tuple(v.shape), v.dtype) for k, v in st.items()
            if isinstance(v, torch.Tensor)}


def make_data() -> dict:
    """The inputs every side reads (numpy, from fixed seeds): tokens for the
    prefill, each model's random decode state (drawn in f32, rounded to the
    leaf's type by each side) with decode tokens, the train batches, and
    the SSD boundary case's inputs and cotangents."""
    data = {"tokens": np.random.default_rng(1).integers(
        0, 256, (B, S)).astype(np.int32),
            "decode_tokens": np.random.default_rng(3).integers(
                0, 256, (B, DECODE_STEPS)).astype(np.int32)}
    for arch in ARCHS:
        rng = np.random.default_rng(2)
        for k, (shape, _) in sorted(state_leaves(config(arch)).items()):
            data[f"{arch}/state/{k}"] = rng.normal(size=shape).astype(
                np.float32)
    for i in range(TRAIN_STEPS):
        toks = np.random.default_rng(10 + i).integers(0, 256, (B, S + 1))
        data[f"batch{i}"] = toks.astype(np.int32)
    b, s, h, p, n = (SSD_SHAPE[k] for k in "bshpn")
    rng = np.random.default_rng(4)
    for k, shape in (("x", (b, s, h, p)), ("a", (b, s, h)), ("B", (b, s, n)),
                     ("C", (b, s, n)), ("init", (b, h, p, n)),
                     ("dy", (b, s, h, p)), ("dfinal", (b, h, p, n))):
        data[f"ssd/{k}"] = rng.normal(size=shape).astype(np.float32)
    data["ssd/a"] = -np.abs(data["ssd/a"]) * 0.1
    return data


def nested(flat: dict, prefix: str) -> dict:
    """``{"a/b": x}`` under ``prefix`` -> ``{"a": {"b": x}}``."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node, parts = out, key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# the JAX side: a subprocess with four forced host devices
# ---------------------------------------------------------------------------

_JAX = r"""
import os, sys, json
from dataclasses import replace
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import reduced_config
from repro.models import transformer as jt
from repro.models.config import ShapeSpec
from repro.serve.serve_step import (decode_state_shardings, make_prefill,
                                    make_serve_step)
from repro.sharding import DEFAULT_RULES, logical_sharding, shardings_for
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step

where = sys.argv[1]
spec = json.loads(os.environ["MULTIRANK_SPEC"])
assert jax.device_count() == 4, jax.devices()
data = dict(np.load(os.path.join(where, "data.npz")))
out = {}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def host(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def shards(name, key, arr, mesh):
    for i in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            dev = mesh.devices[i, j]
            (sh,) = [s for s in arr.addressable_shards if s.device == dev]
            out[f"{name}/shard/{key}/{i}{j}"] = host(sh.data)


inits = {}
for arch, layers in spec["archs"].items():
    cfg = replace(reduced_config(arch), n_layers=layers)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jt.init_params(cfg, jax.random.PRNGKey(0)))
    inits[arch] = (cfg, params)
    np.savez(os.path.join(where, f"{arch}.tmp.npz"),
             **{k: host(v) for k, v in flat(params)})
    os.replace(os.path.join(where, f"{arch}.tmp.npz"),
               os.path.join(where, f"{arch}.npz"))
for arch, (cfg, params) in inits.items():
    for name, shape in spec["meshes"].items():
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        tag = f"{arch}/{name}"
        jp = jax.device_put(params, shardings_for(jt.build_specs(cfg), mesh,
                                                  DEFAULT_RULES))
        for k, v in flat(jp):
            shards(tag, f"param/{k}", v, mesh)
        toks = jax.device_put(data["tokens"], logical_sharding(
            ("batch", "seq"), data["tokens"].shape, mesh, DEFAULT_RULES))
        out[f"{tag}/prefill"] = host(jax.jit(make_prefill(
            cfg, mesh, DEFAULT_RULES))(jp, toks))
        state = {"pos": jnp.asarray(spec["pos0"], jnp.int32)}
        for k, dtype in spec["state"][arch].items():
            state[k] = jnp.asarray(data[f"{arch}/state/{k}"],
                                   getattr(jnp, dtype))
        sh = decode_state_shardings(
            cfg, ShapeSpec("state", spec["max_seq"], spec["b"], "decode"),
            mesh, DEFAULT_RULES)
        state = jax.device_put(state, {k: sh[k] for k in state})
        for k, v in state.items():
            shards(tag, f"state/{k}", v, mesh)
        step = jax.jit(make_serve_step(cfg, mesh, DEFAULT_RULES))
        logits = []
        for i in range(spec["decode_steps"]):
            lg, state = step(jp, state, data["decode_tokens"][:, i:i + 1])
            logits.append(host(lg))
        out[f"{tag}/decode"] = np.stack(logits)
        tstep = jax.jit(make_train_step(cfg, jopt.AdamWConfig(**spec["opt"]),
                                        mesh, DEFAULT_RULES, remat="full"))
        p, o = jp, jopt.init_state(jp)
        losses, norms = [], []
        for i in range(spec["train_steps"]):
            toks = data[f"batch{i}"]
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            batch = jax.device_put(batch, {k: logical_sharding(
                ("batch", "seq"), v.shape, mesh, DEFAULT_RULES)
                for k, v in batch.items()})
            p, o, m = tstep(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{tag}/train/loss"] = np.asarray(losses)
        out[f"{tag}/train/grad_norm"] = np.asarray(norms)
        for k, v in flat(p):
            out[f"{tag}/train/param/{k}"] = host(v)
np.savez(os.path.join(where, "jax.npz"), **out)
print("JAX_DONE")
"""


def _spec() -> dict:
    state = {arch: {k: str(dtype).rsplit(".", 1)[1]
                    for k, (_, dtype) in state_leaves(config(arch)).items()}
             for arch in ARCHS}
    return {"archs": ARCHS, "meshes": MESHES, "pos0": POS0, "b": B,
            "max_seq": MAX_SEQ, "state": state,
            "decode_steps": DECODE_STEPS, "train_steps": TRAIN_STEPS,
            "opt": OPT}


def _start_jax(where: Path) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               MULTIRANK_SPEC=json.dumps(_spec()))
    return subprocess.Popen([sys.executable, "-c", _JAX, str(where)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(ROOT))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    """A copy (a later step updates the tensor in place)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _full(t) -> np.ndarray:
    return _np(t.full_tensor())


def _state(cfg, arch, data) -> dict:
    state = {"pos": POS0}
    for k, (_, dtype) in state_leaves(cfg).items():
        state[k] = torch.from_numpy(data[f"{arch}/state/{k}"]).to(dtype)
    return state


def _batch(data, i) -> dict:
    toks = torch.from_numpy(data[f"batch{i}"])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _load_params(where, arch):
    path = os.path.join(where, f"{arch}.npz")
    while not os.path.exists(path):
        time.sleep(0.05)                 # the JAX side writes the init
    return params_from_jax(nested(dict(np.load(path)), ""), "cpu")


def _ssd_inputs(data, names=("x", "a", "B", "C", "init")) -> list:
    return [torch.from_numpy(data[f"ssd/{k}"]) for k in names]


def _ssd_case(mesh, data) -> dict:
    """The SSD boundary around ``ssd_chunked(..., ssd_chunk)`` (the chunk's
    autograd Function; its plain backward on the CPU) on DTensor inputs
    placed as a Mamba2 layer places them (batch on "data", heads on
    "model", B and C whole on "model", an initial state), with cotangents
    on y and the final state: y, the final state and the five gradients,
    gathered; and the boundary's local operand shapes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels._local import shard_calls, ssd_on_shards
    from repro_torch.kernels.ssd.ops import ssd_chunk, ssd_chunked
    chunk = SSD_SHAPE["chunk"]
    place = {"x": (Shard(0), Shard(2)), "a": (Shard(0), Shard(2)),
             "B": (Shard(0), Replicate()), "C": (Shard(0), Replicate()),
             "init": (Shard(0), Shard(1))}
    dt = [distribute_tensor(t, mesh, place[k]).requires_grad_(True)
          for k, t in zip(("x", "a", "B", "C", "init"), _ssd_inputs(data))]

    def local(x, a, B, C, state):
        return ssd_chunked(x, a, B, C, chunk, state, ssd_chunk)
    with shard_calls() as calls:
        y, final = ssd_on_shards("ssd_chunk", local, *dt[:4], dt[4])
    dy = distribute_tensor(torch.from_numpy(data["ssd/dy"]), mesh,
                           y.placements)
    df = distribute_tensor(torch.from_numpy(data["ssd/dfinal"]), mesh,
                           final.placements)
    grads = torch.autograd.grad((y, final), dt, (dy, df))
    return {"y": _full(y), "final": _full(final),
            "grads": [_full(g) for g in grads], "calls": calls,
            "placements": [list(map(repr, t.placements))
                           for t in (y, final)]}


def twin(cfg, kind: str, seq: int, mesh):
    """The dry-run twin of a step of ``kind`` at (B, ``seq``) on ``mesh``
    under ``DEFAULT_RULES``, f32 params, counted (``Lowered.count``)."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.models.config import ShapeSpec
    from repro_torch.sharding import DEFAULT_RULES
    return lower_step(cfg, ShapeSpec(f"twin_{kind}", seq, B, kind), mesh,
                      DEFAULT_RULES).count(torch.float32)


def held(tally, counted) -> tuple:
    """A tallied step (``RankTally``) beside its twin's count: the
    collectives' (calls, bytes) by kind and the (FLOPs, bytes accessed),
    each a (measured, counted) pair."""
    c = counted.collectives
    return ((tally.by_kind(), (c.counts, c.bytes_by_kind)),
            ((tally.flops, tally.bytes), (counted.flops, counted.bytes)))


def step_inputs(i, inputs, mesh, rules):
    """Step ``i``'s inputs and the tally around it: the first step's
    placed before it, as the twin's are, under ``RankTally``; a later
    step's global, as a caller gives them, for the step to place."""
    from repro_torch.roofline.trace import RankTally
    from repro_torch.sharding import distribute_inputs
    if i:
        return inputs, contextlib.nullcontext()
    return distribute_inputs({k: v.contiguous() for k, v in inputs.items()},
                             mesh, rules), RankTally()


def _run_arch(arch, where, data, out) -> None:
    """One model's steps on both meshes, into ``out[mesh]``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.kernels._local import shard_calls
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.serve_step import distribute_state
    from repro_torch.sharding import (DEFAULT_RULES, distribute_tree,
                                      shardings_for)
    from repro_torch.sharding.rules import NamedSharding, P
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWState
    cfg = config(arch)
    params = _load_params(where, arch)
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        r = out[name] = {"coord": tuple(mesh.get_coordinate())}
        psh = shardings_for(build_specs(cfg), mesh, DEFAULT_RULES)
        dp = distribute_tree(params, psh)
        r["shards"] = {f"param/{'/'.join(p)}": _np(t.to_local())
                       for p, t in tree_leaves(dp)}
        # step -> (measured, twin); the tallied steps take their inputs
        # placed, as the twin does
        comm, cost = r["comm"], r["cost"] = {}, {}
        x, tallied = step_inputs(0, {"tokens": torch.from_numpy(
            data["tokens"])}, mesh, DEFAULT_RULES)
        with shard_calls() as calls, tallied as tally:
            logits = make_prefill(cfg, mesh, DEFAULT_RULES)(dp, **x)
        r["prefill"] = _full(logits)
        r["prefill_calls"] = calls
        comm["prefill"], cost["prefill"] = held(
            tally, twin(cfg, "prefill", S, mesh))
        placed = distribute_state(cfg, _state(cfg, arch, data), mesh,
                                  DEFAULT_RULES)
        r["shards"].update({f"state/{k}": _np(v.to_local())
                            for k, v in placed.items()})
        step = make_serve_step(cfg, mesh, DEFAULT_RULES)
        state, logits = dict(placed, pos=POS0), []
        with shard_calls() as calls:
            for i in range(DECODE_STEPS):
                x, tallied = step_inputs(i, {"tokens": torch.from_numpy(
                    data["decode_tokens"][:, i:i + 1])}, mesh, DEFAULT_RULES)
                with tallied as tally:
                    lg, state = step(dp, state, x["tokens"])
                if i == 0:
                    first = tally
                logits.append(_full(lg))
        comm["decode"], cost["decode"] = held(
            first, twin(cfg, "decode", MAX_SEQ, mesh))
        r["decode"], r["decode_calls"] = np.stack(logits), calls
        r["state_after"] = {k: _full(v) for k, v in state.items()
                            if k != "pos"}
        train = make_train_step(cfg, AdamWConfig(**OPT), mesh,
                                DEFAULT_RULES, remat="full")
        p = distribute_tree(params, psh)
        o = init_state(p)
        losses, norms, calls = [], [], None
        for i in range(TRAIN_STEPS):
            batch, tallied = step_inputs(i, _batch(data, i), mesh,
                                         DEFAULT_RULES)
            with shard_calls() as got, tallied as tally:
                p, o, m = train(p, o, batch)
            calls = calls or got
            if i == 0:
                comm["train"], cost["train"] = held(
                    tally, twin(cfg, "train", S, mesh))
            losses.append(float(m["loss"].full_tensor()))
            norms.append(float(m["grad_norm"].full_tensor()))
        r["train"] = {
            "loss": losses, "grad_norm": norms, "calls": calls,
            "params": {"/".join(k): _full(v) for k, v in tree_leaves(p)},
            "moments_dtensor": all(
                isinstance(v, DTensor) and v.placements == t.placements
                for (_, v), (_, t) in zip(tree_leaves(o.mu),
                                          tree_leaves(p)))}
        if name == "2x2" and arch == CKPT_ARCH:
            ck = CheckpointManager(os.path.join(where, "ckpt"))
            ck.save(CKPT_STEP, (p, o), {"step": CKPT_STEP})
            sh = (psh, AdamWState(NamedSharding(mesh, P()), psh, psh))
            (bp, _), extra = ck.restore((p, o), shardings=sh)
            r["restore"] = {"extra": extra, "placed": all(
                isinstance(b, DTensor) and b.placements == a.placements
                and torch.equal(b.to_local(), a.to_local())
                for (_, a), (_, b) in zip(tree_leaves(p), tree_leaves(bp)))}
        if name == "2x2" and arch == "mamba2-370m":
            r["ssd_case"] = _ssd_case(mesh, data)


def rank_work(rank: int, where: str) -> dict:
    """One rank's share of every check (``runs`` reads the results)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    data = dict(np.load(os.path.join(where, "data.npz")))
    out = {"backend": dist.get_backend()}
    for arch in ARCHS:
        _run_arch(arch, where, data, out.setdefault(arch, {}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps and the four ranks (started together, under the
    multi-rank lock), and the port's unmeshed steps on the same weights and
    inputs."""
    from repro_torch.launch.ranks import run_ranks
    where = tmp_path_factory.mktemp("multirank_ssm")
    data = make_data()
    np.savez(where / "data.npz", **data)
    with one_rank_group():
        t0 = time.perf_counter()
        jax_proc = _start_jax(where)
        try:
            ranks = run_ranks(rank_work, WORLD, str(where), device="cpu",
                              timeout=300)
        finally:
            out, err = jax_proc.communicate(timeout=300)
        seconds = time.perf_counter() - t0
    assert jax_proc.returncode == 0 and "JAX_DONE" in out, err[-4000:]
    jx = dict(np.load(where / "jax.npz"))
    plain = {arch: _unmeshed(config(arch), _load_params(where, arch), arch,
                             data) for arch in ARCHS}
    return {"ranks": ranks, "jax": jx, "plain": plain, "data": data,
            "where": where, "seconds": seconds}


def _unmeshed(cfg, params, arch, data) -> dict:
    """The port's steps on the CPU without a mesh: the second reference;
    the train steps' grads too (``_held_params`` reads them)."""
    from repro_torch.train.train_step import make_value_and_grad
    out = {"prefill": _np(make_prefill(cfg, "cpu")(
        params, torch.from_numpy(data["tokens"])))}
    step = make_serve_step(cfg, "cpu")
    state, logits = _state(cfg, arch, data), []
    for i in range(DECODE_STEPS):
        lg, state = step(params, state, torch.from_numpy(
            data["decode_tokens"][:, i:i + 1]))
        logits.append(_np(lg))
    out["decode"] = np.stack(logits)
    out["state_after"] = {k: _np(v) for k, v in state.items() if k != "pos"}
    train = make_train_step(cfg, AdamWConfig(**OPT), remat="full")
    grad = make_value_and_grad(cfg, remat="full")
    p = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
             else v.clone()) for k, v in params.items()}
    o = init_state(p)
    r = out["train"] = {"loss": [], "grad_norm": [], "grads": []}
    for i in range(TRAIN_STEPS):
        r["grads"].append({"/".join(k): _np(g) for k, g in tree_leaves(
            grad(p, _batch(data, i))[1])})
        p, o, m = train(p, o, _batch(data, i))
        r["loss"].append(float(m["loss"]))
        r["grad_norm"].append(float(m["grad_norm"]))
    r["params"] = {"/".join(k): _np(v) for k, v in tree_leaves(p)}
    r["like"] = params
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

CASES = [(a, m) for a in ARCHS for m in sorted(MESHES)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_shards_equal_jax_addressable_shards(runs, arch, mesh):
    """Each rank's local shard of every param leaf, and of every decode-state
    leaf (random bf16 conv and shared k / v, f32 SSD state, ``pos``),
    equals JAX's addressable shard at the rank's (data, model) coordinate,
    bit for bit."""
    jx = runs["jax"]
    coords = set()
    n_leaves = len(list(tree_leaves(build_specs(config(arch)))))
    n_state = len(state_leaves(config(arch))) + 1
    for r in runs["ranks"]:
        assert r["backend"] == "gloo"
        got = r[arch][mesh]
        coords.add(got["coord"])
        i, j = got["coord"]
        assert len(got["shards"]) == n_leaves + n_state
        for key, local in got["shards"].items():
            want = jx[f"{arch}/{mesh}/shard/{key}/{i}{j}"]
            assert local.shape == want.shape, (key, local.shape, want.shape)
            assert np.array_equal(local, want), key
    assert len(coords) == WORLD


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_and_decode_match_jax_and_unmeshed(runs, arch, mesh):
    """The prefill logits (a padded second chunk) and each decode step's
    logits from the random state at position 4, at 1e-4 against JAX's
    sharded steps and the port's unmeshed ones; every rank gathers the same
    logits, and the decode state the ranks wrote in place (conv, SSD and
    shared k / v, at their placements) equals the unmeshed step's."""
    jx, plain = runs["jax"], runs["plain"][arch]
    first = runs["ranks"][0][arch][mesh]
    for r in runs["ranks"]:
        got = r[arch][mesh]
        assert np.array_equal(got["prefill"], first["prefill"])
        assert np.array_equal(got["decode"], first["decode"])
    tag = f"{arch}/{mesh}"
    assert first["prefill"].shape == (B, S, 256)
    _close(first["prefill"], jx[f"{tag}/prefill"], TOL, "prefill vs JAX")
    _close(first["prefill"], plain["prefill"], TOL, "prefill vs unmeshed")
    assert first["decode"].shape == (DECODE_STEPS, B, 1, 256)
    _close(first["decode"], jx[f"{tag}/decode"], TOL, "decode vs JAX")
    _close(first["decode"], plain["decode"], TOL, "decode vs unmeshed")
    assert set(first["state_after"]) == set(plain["state_after"])
    for k, v in first["state_after"].items():
        _close(v, plain["state_after"][k], TOL, f"state {k} vs unmeshed")


def _held_params(got: dict, want: dict, grads: list) -> None:
    """Each leaf within 1e-3 of its largest magnitude, but for the elements
    whose unmeshed gradient at some step is nonzero and within the grads'
    own tolerance (1e-4 of the leaf's largest gradient) of zero: rounding
    decides their sign, and AdamW's bias-corrected step moves such an
    element by about the learning rate whatever its size (an embedding row
    first read at the second step), so two correct runs may move it
    opposite ways.  Those are held within twice the learning rate a step,
    and may be one element of the leaf, or one in a hundred."""
    for path, t in got.items():
        w = want[path]
        undecided = np.zeros(w.shape, dtype=bool)
        for g in grads:
            g = g[path]
            undecided |= (g != 0) & (np.abs(g) <= TOL * float(np.abs(g).max()))
        err = np.abs(t - w)
        bound = PARAM_TOL * max(float(np.abs(w).max()), 1e-30)
        assert float(err[~undecided].max(initial=0.0)) <= bound, path
        assert float(err[undecided].max(initial=0.0)) \
            <= 2 * OPT["lr"] * TRAIN_STEPS, path
        assert undecided.sum() <= max(1, w.size // 100), \
            (path, undecided.sum())


@pytest.mark.parametrize("arch,mesh", CASES)
def test_train_steps_match_jax_and_unmeshed(runs, arch, mesh):
    """Each train step's loss and grad norm (remat "full") at 1e-4 against
    JAX's sharded steps and the port's unmeshed ones, the final params at
    1e-3 of each leaf's largest magnitude (``_held_params``); the ranks
    agree, and the AdamW moments are DTensors at the params'
    placements."""
    jx, plain = runs["jax"], runs["plain"][arch]["train"]
    got = runs["ranks"][0][arch][mesh]["train"]
    assert got["moments_dtensor"]
    tag = f"{arch}/{mesh}/train"
    for k in ("loss", "grad_norm"):
        _close(got[k], jx[f"{tag}/{k}"], TOL, f"{k} vs JAX")
        _close(got[k], plain[k], TOL, f"{k} vs unmeshed")
    _held_params(got["params"], plain["params"], plain["grads"])
    _held_params(got["params"], {k: jx[f"{tag}/param/{k}"]
                                 for k in got["params"]}, plain["grads"])
    for r in runs["ranks"][1:]:
        assert r[arch][mesh]["train"]["loss"] == got["loss"]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_twin_counts_the_collectives_each_rank_dispatches(runs, arch, mesh):
    """The prefill's, the first decode step's and the first train step's
    collectives on each rank, in calls and bytes by kind, equal the dry-run
    twin's count of the step lowered on that rank's mesh."""
    for r in runs["ranks"]:
        comm = r[arch][mesh]["comm"]
        assert set(comm) == {"prefill", "decode", "train"}
        for step, (measured, counted) in comm.items():
            assert measured == counted, (r[arch][mesh]["coord"], step)
            assert sum(measured[0].values()) > 0, step


@pytest.mark.parametrize("arch,mesh", CASES)
def test_twin_counts_the_flops_and_bytes_each_rank_runs(runs, arch, mesh):
    """The same tallied steps: each rank's FLOPs and bytes accessed, by
    the tally that counts the twin, equal the twin's."""
    for r in runs["ranks"]:
        got = r[arch][mesh]
        assert set(got["cost"]) == set(got["comm"])
        for step, (measured, counted) in got["cost"].items():
            assert measured == counted, (got["coord"], step)
            assert measured[0] > 0 and measured[1] > 0, step


@pytest.mark.parametrize("arch,mesh", CASES)
def test_boundaries_ran_on_local_shards(runs, arch, mesh):
    """The SSD and conv boundaries (and zamba2's shared attention) took
    each rank's shards: the SSD saw x (B / data, S, 8 / model, 16), a like
    it and B / C (B / data, S, 16) whole on the heads; the conv its batch
    rows and (d_in + 2n) / model channels, in prefill, the train step's
    forward and recompute, and decode (which prepends the state's
    shards: (B / data, 3, ch / model)); one SSD and one conv call a
    layer in prefill, the shared block's flash call at each firing."""
    cfg = config(arch)
    data, model = MESHES[mesh]
    bl, hl = B // data, 8 // model
    chl = (128 + 2 * 16) // model
    for r in runs["ranks"]:
        got = r[arch][mesh]
        for calls in (got["prefill_calls"], got["train"]["calls"]):
            ssd = [s for name, s in calls if name == "ssd"]
            conv = [s for name, s in calls if name == "conv"]
            assert ssd and conv
            for x, a, Bm, Cm in ssd:
                assert x == (bl, S, hl, 16) and a == (bl, S, hl)
                assert Bm == Cm == (bl, S, 16)
            for x, w in conv:
                assert x == (bl, S, chl) and w == (4, chl)
        assert sum(n == "ssd" for n, _ in got["prefill_calls"]) \
            == sum(n == "conv" for n, _ in got["prefill_calls"]) \
            == cfg.n_layers
        assert sum(n == "flash_attention" for n, _ in got["prefill_calls"]) \
            == (2 if arch == "zamba2-1.2b" else 0)
        dec = [s for n, s in got["decode_calls"] if n == "conv"]
        assert len(dec) == DECODE_STEPS * cfg.n_layers
        assert all(s == ((bl, 1, chl), (4, chl), (bl, 3, chl)) for s in dec)
        assert not [n for n, _ in got["decode_calls"] if n == "ssd"]


def test_ssd_chunk_function_inside_the_boundary(runs):
    """``ssd_chunked(..., ssd_chunk)`` as the boundary's local function on
    the 2x2 mesh (the chunk's autograd Function, its plain backward on the
    CPU, inside ``local_map``), from a random initial state: y, the final
    state and the gradients of x, a, B, C and the initial state at 1e-4
    of the same function's unmeshed ones, and of ``ssd_ref``'s autograd;
    the boundary saw each rank's 2 sequences and 4 of the 8 heads, B and C
    whole on the heads."""
    from repro_torch.kernels.ssd.ops import ssd_chunk, ssd_chunked
    from repro_torch.kernels.ssd.ref import ssd_ref
    data, chunk = runs["data"], SSD_SHAPE["chunk"]
    dy, df = (torch.from_numpy(data[f"ssd/{k}"]) for k in ("dy", "dfinal"))
    wants = []
    for fn in (lambda *t: ssd_chunked(*t[:4], chunk, t[4], ssd_chunk),
               lambda *t: ssd_ref(*t[:4], chunk=chunk, initial_state=t[4])):
        leaves = [t.requires_grad_(True) for t in _ssd_inputs(data)]
        y, final = fn(*leaves)
        grads = torch.autograd.grad((y, final), leaves, (dy, df))
        wants.append((_np(y), _np(final), [_np(g) for g in grads]))
    b, s, h, p, n = (SSD_SHAPE[k] for k in "bshpn")
    for r in runs["ranks"]:
        got = r["mamba2-370m"]["2x2"]["ssd_case"]
        assert got["placements"] == [["Shard(dim=0)", "Shard(dim=2)"],
                                     ["Shard(dim=0)", "Shard(dim=1)"]]
        (name, shapes), = got["calls"]
        assert name == "ssd_chunk" and shapes == (
            (b // 2, s, h // 2, p), (b // 2, s, h // 2), (b // 2, s, n),
            (b // 2, s, n), (b // 2, h // 2, p, n))
        for y, final, grads in wants:
            _close(got["y"], y, TOL, "y")
            _close(got["final"], final, TOL, "final state")
            for g, w, what in zip(got["grads"], grads,
                                  ("x", "a", "B", "C", "initial state")):
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g - w).max()) <= TOL * scale, what


def test_checkpoint_written_across_ranks_restores_on_one_device(runs):
    """The four ranks' checkpoint of zamba2's trained 2x2 params and AdamW
    state: restored on the mesh with ``shardings`` as DTensors holding the
    same shards, and on one device by the port bit for bit the params the
    ranks gathered."""
    from repro_torch.train.checkpoint import CheckpointManager
    for r in runs["ranks"]:
        back = r[CKPT_ARCH]["2x2"]["restore"]
        assert back["placed"] and back["extra"] == {"step": CKPT_STEP}
    want = runs["ranks"][0][CKPT_ARCH]["2x2"]["train"]["params"]
    like = runs["plain"][CKPT_ARCH]["train"]["like"]
    (tp, ts), extra = CheckpointManager(runs["where"] / "ckpt").restore(
        (like, init_state(like)))
    assert extra == {"step": CKPT_STEP} and int(ts.step) == TRAIN_STEPS
    for path, t in tree_leaves(tp):
        assert type(t) is torch.Tensor
        assert np.array_equal(_np(t), want["/".join(path)]), path
