"""Multi-rank execution of the port on four CPU ranks (gloo), held against
JAX's sharded steps on four forced host devices and against the port's own
unmeshed steps.

A reduced qwen3-1.7b (2 layers, d 64, H 4, KV 2, vocab 256, d_ff 128) in
f32, from the reference's seed-0 init, runs through ``make_prefill``,
``make_serve_step`` and ``make_train_step`` on a ``DeviceMesh`` of four
ranks under ``DEFAULT_RULES``:

* the (2, 2) ("data", "model") mesh: every sharded dimension divides by 2,
  so each rank holds 2 of the 4 sequences, 2 of the 4 q heads and 1 of the
  2 KV heads;
* the (1, 4) mesh: 2 KV heads do not divide by 4, so the rules replicate
  them and each rank's one q head reads its own group's KV head
  (``kernels._local._kv_heads``).

Held: each rank's local shard of every param and decode-state leaf equals
bit for bit JAX's addressable shard at the same (data, model) coordinate;
prefill and decode logits, and each train step's loss and grad norm (remat
"full" and "none"), at 1e-4; the final params at 1e-3 of each leaf's
largest magnitude (tests/test_torch_sharding.py's tolerances); the kernel
wrappers ran on local shards (their operand shapes); a checkpoint written by
the four ranks restores bit for bit on one device and in the JAX package's
``CheckpointManager``, and on the mesh as DTensors of the rules'
placements; a remat recompute run in a thread of its own constrains as the
forward did; the chunked loss (``loss_impl="chunked"``, a ragged last
chunk) against JAX's and against the dense loss across ranks; the
collectives each step dispatches on a rank equal, in calls and bytes by
kind, the dry-run twin's count of the same step lowered on that rank's
mesh (``Lowered.count``), and so do the FLOPs and bytes accessed the rank
runs, counted by the same tally (``roofline.trace.RankTally``) on the
same step.  A tallied step (each kind's first) takes its inputs placed
before it, as the twin's are; later steps take the global batch or
tokens, as a caller gives them, and place them themselves.

The ranks run in processes of their own (``launch.ranks.run_ranks``,
spawned, one torch thread each, a ``FileStore``), never in the pytest
worker; the JAX side runs in a subprocess with four forced host devices.
Both start together, once for the module (``runs``), under a lock on a file
in the system temp directory that ``tests/test_torch_multirank_ssm.py``
takes too: one group of four ranks at a time loads the host.
"""
import contextlib
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.kernels._local import _kv_heads
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import build_specs
from repro_torch.serve.serve_step import make_prefill, make_serve_step
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen3-1.7b"
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, MAX_SEQ, POS0 = 4, 16, 16, 4     # decode starts at position POS0
DECODE_STEPS = {"2x2": 8, "1x4": 3}
TRAIN = {"2x2": ("full", "none"), "1x4": ("full",)}
TRAIN_STEPS = {"2x2": 4, "1x4": 2}
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
TOL, PARAM_TOL = 1e-4, 1e-3
CKPT_STEP = 4
MICROBATCHES = 2
# the chunked loss on the 2x2 mesh: 256 columns in chunks of 96, the last
# one ragged (64 columns and 32 of padding)
VOCAB_CHUNK, CHUNK_STEPS = 96, 2
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


@contextlib.contextmanager
def ragged_chunks():
    """The train step's chunked loss in chunks of ``VOCAB_CHUNK`` columns,
    the last one ragged (its module-level ``lm_loss_chunked`` given the
    chunk, as the JAX side does with its own)."""
    import functools
    from repro_torch.train import train_step
    real = train_step.lm_loss_chunked
    train_step.lm_loss_chunked = functools.partial(real,
                                                   vocab_chunk=VOCAB_CHUNK)
    try:
        yield
    finally:
        train_step.lm_loss_chunked = real


def make_data(cfg) -> dict:
    """The inputs every side reads (numpy, from fixed seeds): tokens for the
    prefill, a decode state of random bf16 k / v (drawn in f32) with its
    decode tokens, and the train batches."""
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(2)
    data = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32),
            "state_k": rng.normal(size=(L, B, MAX_SEQ, KV, hd)).astype(
                np.float32),
            "state_v": rng.normal(size=(L, B, MAX_SEQ, KV, hd)).astype(
                np.float32),
            "decode_tokens": np.random.default_rng(3).integers(
                0, cfg.vocab, (B, max(DECODE_STEPS.values()))).astype(
                    np.int32)}
    for i in range(max(TRAIN_STEPS.values())):
        toks = np.random.default_rng(10 + i).integers(0, cfg.vocab, (B, S + 1))
        data[f"batch{i}"] = toks.astype(np.int32)
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
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import reduced_config
from repro.models import transformer as jt
from repro.models.config import ShapeSpec
from repro.serve.serve_step import (decode_state_shardings, make_prefill,
                                    make_serve_step)
from repro.sharding import DEFAULT_RULES, logical_sharding, shardings_for
from repro.train import optimizer as jopt
from repro.train.train_step import batch_shardings, make_train_step

where = sys.argv[1]
meshes = dict(m.split("=") for m in sys.argv[2:])
spec = __import__("json").loads(os.environ["MULTIRANK_SPEC"])
assert jax.device_count() == 4, jax.devices()
data = dict(np.load(os.path.join(where, "data.npz")))
cfg = reduced_config(spec["arch"])
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jt.init_params(cfg, jax.random.PRNGKey(0)))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def host(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


np.savez(os.path.join(where, "params.tmp.npz"),
         **{k: host(v) for k, v in flat(params)})
os.replace(os.path.join(where, "params.tmp.npz"),
           os.path.join(where, "params.npz"))
out = {}


def shards(name, key, arr, mesh):
    for i in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            dev = mesh.devices[i, j]
            (sh,) = [s for s in arr.addressable_shards if s.device == dev]
            out[f"{name}/shard/{key}/{i}{j}"] = host(sh.data)


for name, shape in meshes.items():
    shape = tuple(int(n) for n in shape.split("x"))
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    psh = shardings_for(jt.build_specs(cfg), mesh, DEFAULT_RULES)
    jp = jax.device_put(params, psh)
    for k, v in flat(jp):
        shards(name, f"param/{k}", v, mesh)
    toks = jax.device_put(data["tokens"], logical_sharding(
        ("batch", "seq"), data["tokens"].shape, mesh, DEFAULT_RULES))
    out[f"{name}/prefill"] = host(jax.jit(make_prefill(
        cfg, mesh, DEFAULT_RULES))(jp, toks))
    state = {"pos": jnp.asarray(spec["pos0"], jnp.int32),
             "k": jnp.asarray(data["state_k"], jnp.bfloat16),
             "v": jnp.asarray(data["state_v"], jnp.bfloat16)}
    B, S = data["state_k"].shape[1:3]
    state = jax.device_put(state, decode_state_shardings(
        cfg, ShapeSpec("state", S, B, "decode"), mesh, DEFAULT_RULES))
    for k, v in state.items():
        shards(name, f"state/{k}", v, mesh)
    step = jax.jit(make_serve_step(cfg, mesh, DEFAULT_RULES))
    logits = []
    for i in range(spec["decode_steps"][name]):
        t = data["decode_tokens"][:, i:i + 1]
        lg, state = step(jp, state, t)
        logits.append(host(lg))
    out[f"{name}/decode"] = np.stack(logits)
    for remat in spec["train"][name]:
        tstep = jax.jit(make_train_step(cfg, jopt.AdamWConfig(**spec["opt"]),
                                        mesh, DEFAULT_RULES, remat=remat))
        p, o = jp, jopt.init_state(jp)
        losses, norms = [], []
        for i in range(spec["train_steps"][name]):
            toks = data[f"batch{i}"]
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            batch = jax.device_put(batch, {k: logical_sharding(
                ("batch", "seq"), v.shape, mesh, DEFAULT_RULES)
                for k, v in batch.items()})
            p, o, m = tstep(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        key = f"{name}/train/{remat}"
        out[f"{key}/loss"] = np.asarray(losses)
        out[f"{key}/grad_norm"] = np.asarray(norms)
        for k, v in flat(p):
            out[f"{key}/param/{k}"] = host(v)
    if name == "2x2":
        # the chunked loss at a ragged chunk: the train step's module-level
        # lm_loss_chunked, given the chunk (the reference takes no argument)
        import functools
        import repro.train.train_step as jts
        jts.lm_loss_chunked = functools.partial(
            jt.lm_loss_chunked, vocab_chunk=spec["vocab_chunk"])
        tstep = jax.jit(make_train_step(cfg, jopt.AdamWConfig(**spec["opt"]),
                                        mesh, DEFAULT_RULES, remat="full",
                                        loss_impl="chunked"))
        p, o = jp, jopt.init_state(jp)
        losses, norms = [], []
        for i in range(spec["chunk_steps"]):
            toks = data[f"batch{i}"]
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            batch = jax.device_put(batch, {k: logical_sharding(
                ("batch", "seq"), v.shape, mesh, DEFAULT_RULES)
                for k, v in batch.items()})
            p, o, m = tstep(p, o, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out["2x2/chunked/loss"] = np.asarray(losses)
        out["2x2/chunked/grad_norm"] = np.asarray(norms)
np.savez(os.path.join(where, "jax.npz"), **out)
print("JAX_DONE")
"""


def _spec() -> dict:
    return {"arch": ARCH, "pos0": POS0, "decode_steps": DECODE_STEPS,
            "train": TRAIN, "train_steps": TRAIN_STEPS, "opt": OPT,
            "vocab_chunk": VOCAB_CHUNK, "chunk_steps": CHUNK_STEPS}


def _start_jax(where: Path) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               MULTIRANK_SPEC=json.dumps(_spec()))
    meshes = [f"{k}={v[0]}x{v[1]}" for k, v in MESHES.items()]
    return subprocess.Popen([sys.executable, "-c", _JAX, str(where), *meshes],
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


def _state(cfg, data) -> dict:
    return {"pos": POS0,
            "k": torch.from_numpy(data["state_k"]).to(torch.bfloat16),
            "v": torch.from_numpy(data["state_v"]).to(torch.bfloat16)}


def _batch(data, i) -> dict:
    toks = torch.from_numpy(data[f"batch{i}"])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _remat_in_a_thread(cfg, params, mesh, batch) -> dict:
    """A remat="full" forward under the sharding context, its backward run
    once in this thread and once in a thread of its own (whose context is
    empty): each run's recorded ``constrain`` calls (with placements) and
    grads.  The recompute stops at the last tensor the backward needs, so
    a layer recomputes its first ``constrain`` only."""
    from repro_torch.models.transformer import forward, lm_loss
    from repro_torch.sharding import (DEFAULT_RULES, distribute_inputs,
                                      sharding_ctx)
    from repro_torch.sharding.context import recording
    paths, leaves = zip(*tree_leaves(params))
    batch = distribute_inputs(batch, mesh, DEFAULT_RULES)

    def run(threaded: bool):
        req = [t.detach().requires_grad_(True) for t in leaves]
        tree: dict = {}
        for path, t in zip(paths, req):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        got = {}
        with sharding_ctx(mesh, DEFAULT_RULES), recording() as calls:
            logits, _ = forward(tree, cfg, batch["tokens"], remat="full")
            loss = lm_loss(logits, batch["labels"])

            def backward():
                got["grads"] = torch.autograd.grad(loss, req)
            if threaded:
                worker = threading.Thread(target=backward)
                worker.start()
                worker.join()
            else:
                backward()
        keys = [(c["names"], c["shape"], c.get("placements"), c["backward"])
                for c in calls]
        return keys, [g.full_tensor() for g in got["grads"]]

    here, grads_here = run(False)
    there, grads_there = run(True)
    return {"main": here, "thread": there,
            "grads_equal": all(torch.equal(a, b)
                               for a, b in zip(grads_here, grads_there))}


def _guards(params) -> dict:
    """Each CUDA launcher given a DTensor operand: the message it raises
    (before anything else is checked)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    w = params["final_norm"]
    x = params["embed"]
    q = params["blocks"]["wq"].reshape(1, *params["blocks"]["wq"].shape)
    calls = {"rmsnorm_cuda": lambda: rmsnorm_cuda(x, w),
             "rmsnorm_bwd_cuda": lambda: rmsnorm_bwd_cuda(x, w, x),
             "flash_attention_cuda": lambda: flash_attention_cuda(q, q, q),
             "flash_attention_bwd_cuda": lambda: flash_attention_bwd_cuda(
                 q, q, q, q, q, q)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "launched"
        except TypeError as e:
            out[name] = str(e)
    return out


def twin(cfg, kind: str, seq: int, mesh, **kw):
    """The dry-run twin of a step of ``kind`` at (B, ``seq``) on ``mesh``
    under ``DEFAULT_RULES``, f32 params, counted (``Lowered.count``)."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.models.config import ShapeSpec
    from repro_torch.sharding import DEFAULT_RULES
    return lower_step(cfg, ShapeSpec(f"twin_{kind}", seq, B, kind), mesh,
                      DEFAULT_RULES, **kw).count(torch.float32)


def held(tally, counted) -> tuple:
    """A tallied step (``RankTally``) beside its twin's count: the
    collectives' (calls, bytes) by kind and the (FLOPs, bytes accessed),
    each a (measured, counted) pair."""
    c = counted.collectives
    return ((tally.by_kind(), (c.counts, c.bytes_by_kind)),
            ((tally.flops, tally.bytes), (counted.flops, counted.bytes)))


def _made(tally) -> set:
    """The shapes of the storage a tallied step allocated."""
    return {shape for _, shape in tally.made.values()}


def _loss_on_blocks(cfg, params, mesh, batch) -> dict:
    """``lm_loss`` and its gradient on the placed logits of a forward
    (``remat="none"``, no grad), under ``RankTally``: the loss, the
    gradient (gathered) and its placements beside the logits', the
    local shapes the boundary took, the largest allocation (bytes) and
    the shapes allocated; and the same loss and gradient on one device
    from the gathered logits."""
    from repro_torch.kernels._local import shard_calls
    from repro_torch.models.transformer import forward, lm_loss
    from repro_torch.roofline.trace import RankTally
    from repro_torch.sharding import (DEFAULT_RULES, distribute_inputs,
                                      sharding_ctx)
    batch = distribute_inputs(batch, mesh, DEFAULT_RULES)
    with torch.no_grad(), sharding_ctx(mesh, DEFAULT_RULES):
        logits, _ = forward(params, cfg, batch["tokens"], remat="none")
    logits = logits.detach().requires_grad_(True)
    labels = batch["labels"]
    with shard_calls() as calls, RankTally(
            known=(logits.to_local(), labels.to_local())) as tally:
        loss = lm_loss(logits, labels)
        (grad,) = torch.autograd.grad(loss, logits)
    whole = logits.full_tensor().detach().requires_grad_(True)
    plain = lm_loss(whole, labels.full_tensor())
    (plain_grad,) = torch.autograd.grad(plain, whole)
    return {"loss": float(loss.full_tensor()), "plain_loss": float(plain),
            "grad": _full(grad), "plain_grad": _np(plain_grad),
            "placements": (grad.placements, logits.placements),
            "local": tuple(grad.to_local().shape), "calls": calls,
            "largest": max(n for _, n in tally.events), "made": _made(tally)}


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


def rank_work(rank: int, where: str) -> dict:
    """One rank's share of every check (``runs`` reads the results)."""
    from torch.distributed.tensor import DTensor
    import torch.distributed as dist
    from repro_torch.kernels._local import shard_calls
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.serve_step import distribute_state
    from repro_torch.sharding import (DEFAULT_RULES, distribute_tree,
                                      shardings_for)
    from repro_torch.sharding.rules import NamedSharding, P
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import AdamWState
    torch.set_num_threads(1)
    while not os.path.exists(os.path.join(where, "params.npz")):
        time.sleep(0.05)                 # the JAX side writes the init
    cfg = reduced_config(ARCH)
    params = params_from_jax(nested(dict(np.load(
        os.path.join(where, "params.npz"))), ""), "cpu")
    data = dict(np.load(os.path.join(where, "data.npz")))
    out = {"backend": dist.get_backend()}
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        r = out[name] = {"coord": tuple(mesh.get_coordinate()),
                         "axes": dict(zip(mesh.mesh_dim_names, mesh.shape))}
        psh = shardings_for(build_specs(cfg), mesh, DEFAULT_RULES)
        dp = distribute_tree(params, psh)
        r["shards"] = {f"param/{'/'.join(p)}": _np(t.to_local())
                       for p, t in tree_leaves(dp)}
        # step -> (measured, twin); the tallied steps take their inputs
        # placed, as the twin does
        comm, cost = r["comm"], r["cost"] = {}, {}
        made = r["made"] = {}
        inputs, tallied = step_inputs(0, {"tokens": torch.from_numpy(
            data["tokens"])}, mesh, DEFAULT_RULES)
        with shard_calls() as calls, tallied as tally:
            logits = make_prefill(cfg, mesh, DEFAULT_RULES)(dp, **inputs)
        r["prefill"] = _full(logits)
        r["prefill_calls"] = calls
        # the same prefill as a caller runs it: global tokens it places
        r["prefill_global"] = _full(make_prefill(cfg, mesh, DEFAULT_RULES)(
            dp, tokens=torch.from_numpy(data["tokens"])))
        comm["prefill"], cost["prefill"] = held(
            tally, twin(cfg, "prefill", S, mesh))
        placed = distribute_state(cfg, _state(cfg, data), mesh,
                                  DEFAULT_RULES)
        r["shards"].update({f"state/{k}": _np(v.to_local())
                            for k, v in placed.items()})
        step = make_serve_step(cfg, mesh, DEFAULT_RULES)
        state, logits = dict(placed, pos=POS0), []
        for i in range(DECODE_STEPS[name]):
            tokens, tallied = step_inputs(i, {"tokens": torch.from_numpy(
                data["decode_tokens"][:, i:i + 1])}, mesh, DEFAULT_RULES)
            with tallied as tally:
                lg, state = step(dp, state, tokens["tokens"])
            if i == 0:
                comm["decode"], cost["decode"] = held(
                    tally, twin(cfg, "decode", MAX_SEQ, mesh))
            logits.append(_full(lg))
        r["decode"] = np.stack(logits)
        r["pos_is_dtensor"] = isinstance(state["pos"], DTensor)
        r["loss_block"] = _loss_on_blocks(cfg, dp, mesh, _batch(data, 0))
        for remat in TRAIN[name]:
            train = make_train_step(cfg, AdamWConfig(**OPT), mesh,
                                    DEFAULT_RULES, remat=remat)
            p = distribute_tree(params, psh)
            o = init_state(p)
            losses, norms, calls = [], [], None
            for i in range(TRAIN_STEPS[name]):
                batch, tallied = step_inputs(i, _batch(data, i), mesh,
                                             DEFAULT_RULES)
                with shard_calls() as got, tallied as tally:
                    p, o, m = train(p, o, batch)
                calls = calls or got
                if i == 0:
                    comm[f"train/{remat}"], cost[f"train/{remat}"] = held(
                        tally, twin(cfg, "train", S, mesh, remat=remat))
                    made[f"train/{remat}"] = _made(tally)
                losses.append(float(m["loss"].full_tensor()))
                norms.append(float(m["grad_norm"].full_tensor()))
            r[f"train/{remat}"] = {
                "loss": losses, "grad_norm": norms, "calls": calls,
                "params": {"/".join(k): _full(v) for k, v in tree_leaves(p)},
                "moments_dtensor": all(
                    isinstance(v, DTensor) and v.placements == t.placements
                    for (_, v), (_, t) in zip(tree_leaves(o.mu),
                                              tree_leaves(p))),
                "step_dtensor": isinstance(o.step, DTensor)}
        if name != "2x2":
            continue
        r["guards"] = _guards(dp)
        train = make_train_step(cfg, AdamWConfig(**OPT), mesh, DEFAULT_RULES,
                                remat="full", loss_impl="chunked")
        cp = distribute_tree(params, psh)
        co = init_state(cp)
        r["chunked"] = {"loss": [], "grad_norm": []}
        with ragged_chunks():
            for i in range(CHUNK_STEPS):
                batch, tallied = step_inputs(i, _batch(data, i), mesh,
                                             DEFAULT_RULES)
                with shard_calls() as got, tallied as tally:
                    cp, co, m = train(cp, co, batch)
                if i == 0:
                    comm["chunked"], cost["chunked"] = held(tally, twin(
                        cfg, "train", S, mesh, loss_impl="chunked"))
                    made["chunked"] = _made(tally)
                    r["chunked"]["calls"] = got
                r["chunked"]["loss"].append(float(m["loss"].full_tensor()))
                r["chunked"]["grad_norm"].append(
                    float(m["grad_norm"].full_tensor()))
        train = make_train_step(cfg, AdamWConfig(**OPT), mesh, DEFAULT_RULES,
                                remat="full", microbatches=MICROBATCHES)
        mp = distribute_tree(params, psh)
        mo = init_state(mp)
        r["microbatched"] = []
        for i in range(2):
            batch, tallied = step_inputs(i, _batch(data, i), mesh,
                                         DEFAULT_RULES)
            with tallied as tally:
                mp, mo, m = train(mp, mo, batch)
            if i == 0:
                comm["microbatched"], cost["microbatched"] = held(
                    tally, twin(cfg, "train", S, mesh,
                                microbatches=MICROBATCHES))
            r["microbatched"].append((float(m["loss"].full_tensor()),
                                      float(m["grad_norm"].full_tensor())))
        ck = CheckpointManager(os.path.join(where, "ckpt"))
        ck.save(CKPT_STEP, (p, o), {"step": CKPT_STEP})
        sh = (psh, AdamWState(NamedSharding(mesh, P()), psh, psh))
        (bp, bo), extra = ck.restore((p, o), shardings=sh)
        r["restore"] = {
            "extra": extra, "step": int(bo.step.full_tensor()),
            "placed": all(isinstance(b, DTensor)
                          and b.placements == psh_leaf.placements
                          and torch.equal(b.to_local(), a.to_local())
                          for (_, a), (_, b), (_, psh_leaf) in zip(
                              tree_leaves(p), tree_leaves(bp),
                              tree_leaves(psh))),
            "moments_equal": all(torch.equal(a.to_local(), b.to_local())
                                 for (_, a), (_, b) in zip(
                                     tree_leaves(o.nu), tree_leaves(bo.nu)))}
        r["remat_thread"] = _remat_in_a_thread(
            cfg, distribute_tree(params, psh), mesh, _batch(data, 0))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps and the four ranks (started together, under the
    multi-rank lock), and the port's unmeshed steps on the same weights and
    inputs."""
    from repro_torch.launch.ranks import run_ranks
    where = tmp_path_factory.mktemp("multirank")
    cfg = reduced_config(ARCH)
    data = make_data(cfg)
    np.savez(where / "data.npz", **data)
    with one_rank_group():
        t0 = time.perf_counter()
        jax_proc = _start_jax(where)
        try:
            ranks = run_ranks(rank_work, WORLD, str(where), device="cpu",
                              timeout=300)
        finally:
            out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0 and "JAX_DONE" in out, err[-4000:]
    jx = dict(np.load(where / "jax.npz"))
    params = params_from_jax(nested(dict(np.load(where / "params.npz")), ""),
                             "cpu")
    return {"ranks": ranks, "jax": jx, "plain": _unmeshed(cfg, params, data),
            "params": params, "where": where, "cfg": cfg,
            "seconds": time.perf_counter() - t0}


def _copy(params) -> dict:
    return {k: ({n: t.clone() for n, t in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in params.items()}


def _unmeshed(cfg, params, data) -> dict:
    """The port's steps on the CPU without a mesh: the second reference."""
    out = {"prefill": _np(make_prefill(cfg, "cpu")(
        params, torch.from_numpy(data["tokens"])))}
    step = make_serve_step(cfg, "cpu")
    state, logits = _state(cfg, data), []
    for i in range(max(DECODE_STEPS.values())):
        lg, state = step(params, state, torch.from_numpy(
            data["decode_tokens"][:, i:i + 1]))
        logits.append(_np(lg))
    out["decode"] = np.stack(logits)
    train = make_train_step(cfg, AdamWConfig(**OPT), remat="full",
                            microbatches=MICROBATCHES)
    p = _copy(params)
    o, out["microbatched"] = init_state(p), []
    for i in range(2):
        p, o, m = train(p, o, _batch(data, i))
        out["microbatched"].append((float(m["loss"]), float(m["grad_norm"])))
    for remat in ("full", "none"):
        train = make_train_step(cfg, AdamWConfig(**OPT), remat=remat)
        p = _copy(params)
        o = init_state(p)
        r = out[f"train/{remat}"] = {"loss": [], "grad_norm": [],
                                     "params": []}
        for i in range(max(TRAIN_STEPS.values())):
            p, o, m = train(p, o, _batch(data, i))
            r["loss"].append(float(m["loss"]))
            r["grad_norm"].append(float(m["grad_norm"]))
            r["params"].append({"/".join(k): _np(v)
                                for k, v in tree_leaves(p)})
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_shards_equal_jax_addressable_shards(runs, mesh):
    """Each rank's local shard of every param leaf, and of every decode-state
    leaf (random bf16 k / v, ``pos``), equals JAX's addressable shard at the
    rank's (data, model) coordinate, bit for bit; the mesh is the
    reference's, over the gloo group."""
    jx = runs["jax"]
    coords = set()
    for r in runs["ranks"]:
        got = r[mesh]
        assert r["backend"] == "gloo"
        assert got["axes"] == dict(zip(("data", "model"), MESHES[mesh]))
        coords.add(got["coord"])
        i, j = got["coord"]
        assert len(got["shards"]) == len(list(tree_leaves(
            build_specs(runs["cfg"])))) + 3
        for key, local in got["shards"].items():
            want = jx[f"{mesh}/shard/{key}/{i}{j}"]
            assert local.shape == want.shape, (key, local.shape, want.shape)
            assert np.array_equal(local, want), key
    assert len(coords) == WORLD


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prefill_and_decode_match_jax_and_unmeshed(runs, mesh):
    """The prefill logits and each decode step's logits (from a random
    state at position 4) at 1e-4 against JAX's sharded steps and the
    port's unmeshed ones; every rank gathers the same logits, and the
    state's ``pos`` stays a replicated DTensor."""
    jx, plain = runs["jax"], runs["plain"]
    n = DECODE_STEPS[mesh]
    first = runs["ranks"][0][mesh]
    for r in runs["ranks"]:
        got = r[mesh]
        assert np.array_equal(got["prefill"], first["prefill"])
        assert np.array_equal(got["decode"], first["decode"])
        assert got["pos_is_dtensor"]
    _close(first["prefill"], jx[f"{mesh}/prefill"], TOL, "prefill vs JAX")
    _close(first["prefill"], plain["prefill"], TOL, "prefill vs unmeshed")
    assert first["decode"].shape == (n, B, 1, runs["cfg"].vocab)
    _close(first["decode"], jx[f"{mesh}/decode"], TOL, "decode vs JAX")
    _close(first["decode"], plain["decode"][:n], TOL, "decode vs unmeshed")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_twin_counts_the_collectives_each_rank_dispatches(runs, mesh):
    """Every step's collectives on each rank (the prefill, the first
    decode step and the first train step of each remat; on the 2 x 2 mesh
    the chunked loss's and the microbatched step's too), in calls and
    bytes by kind, equal the dry-run twin's count of the step lowered on
    that rank's mesh; each step gathers something."""
    want = {"prefill", "decode"} | {f"train/{r}" for r in TRAIN[mesh]}
    if mesh == "2x2":
        want |= {"chunked", "microbatched"}
    for r in runs["ranks"]:
        comm = r[mesh]["comm"]
        assert set(comm) == want
        for step, (measured, counted) in comm.items():
            assert measured == counted, (r[mesh]["coord"], step)
            assert measured[0].get("all-gather", 0) > 0, step


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_prefill_places_global_tokens_as_placed_ones(runs, mesh):
    """The tallied prefill took its tokens placed, as the twin's are; the
    same prefill given the global tokens places them itself and gives the
    same logits on every rank."""
    for r in runs["ranks"]:
        assert np.array_equal(r[mesh]["prefill_global"], r[mesh]["prefill"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_twin_counts_the_flops_and_bytes_each_rank_runs(runs, mesh):
    """The same tallied steps: each rank's FLOPs and bytes accessed, by
    the tally that counts the twin, equal the twin's."""
    for r in runs["ranks"]:
        cost = r[mesh]["cost"]
        assert set(cost) == set(r[mesh]["comm"])
        for step, (measured, counted) in cost.items():
            assert measured == counted, (r[mesh]["coord"], step)
            assert measured[0] > 0 and measured[1] > 0, step


@pytest.mark.parametrize("mesh,remat", [(m, r) for m in sorted(MESHES)
                                        for r in TRAIN[m]])
def test_train_steps_match_jax_and_unmeshed(runs, mesh, remat):
    """Each train step's loss and grad norm (a global norm across ranks) at
    1e-4, the final params at 1e-3 of each leaf's largest magnitude, against
    JAX's sharded steps and the port's unmeshed ones; moments and step are
    DTensors at the params' placements."""
    jx, plain = runs["jax"], runs["plain"][f"train/{remat}"]
    n = TRAIN_STEPS[mesh]
    got = runs["ranks"][0][mesh][f"train/{remat}"]
    assert got["moments_dtensor"] and got["step_dtensor"]
    key = f"{mesh}/train/{remat}"
    for k in ("loss", "grad_norm"):
        _close(got[k], jx[f"{key}/{k}"], TOL, f"{k} vs JAX")
        _close(got[k], plain[k][:n], TOL, f"{k} vs unmeshed")
    for path, t in got["params"].items():
        for want, what in ((jx[f"{key}/param/{path}"], "JAX"),
                           (plain["params"][n - 1][path], "unmeshed")):
            err = float(np.abs(t - want).max())
            assert err <= PARAM_TOL * max(float(np.abs(want).max()), 1e-30), \
                (path, what, err)
    for r in runs["ranks"][1:]:
        assert r[mesh][f"train/{remat}"]["loss"] == got["loss"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_kernel_wrappers_ran_on_local_shards(runs, mesh):
    """The RMSNorm and flash wrappers took the DTensor boundary: on the 2x2
    mesh every rank's flash call saw q (2, S, 2, hd) and k / v (2, S, 1,
    hd) (2 of 4 sequences, 2 of 4 q heads, their KV head); on the 1x4 mesh
    q (4, S, 1, hd) and its group's one KV head; RMSNorm rows of the
    local batch with d whole, in prefill and in the train step's forward
    and recompute."""
    cfg = runs["cfg"]
    data, model = MESHES[mesh]
    bl, hl = B // data, cfg.n_heads // model
    kvl = max(1, cfg.n_kv_heads // model)
    for r in runs["ranks"]:
        got = r[mesh]
        for calls in (got["prefill_calls"], got["train/full"]["calls"]):
            flash = [shapes for name, shapes in calls
                     if name == "flash_attention"]
            norms = [shapes for name, shapes in calls if name == "rmsnorm"]
            assert flash and norms
            for q, k, v in flash:
                assert q == (bl, S, hl, cfg.hd), q
                assert k == v == (bl, S, kvl, cfg.hd), k
            for x, w in norms:
                assert x[0] == bl and x[-1] == w[0]
        assert sum(name == "flash_attention"
                   for name, _ in got["prefill_calls"]) == cfg.n_layers


def test_microbatched_steps_split_the_sharded_batch(runs):
    """Two train steps with two microbatches on the 2x2 mesh (the
    microbatch reshape of a batch-sharded DTensor): loss and grad norm at
    1e-4 of the port's unmeshed microbatched steps."""
    want = np.asarray(runs["plain"]["microbatched"])
    for r in runs["ranks"]:
        _close(np.asarray(r["2x2"]["microbatched"]), want, TOL,
               "microbatched loss, grad norm")


def test_chunked_loss_across_ranks_matches_jax_and_dense(runs):
    """``loss_impl="chunked"`` on the 2x2 mesh, the vocab in chunks of 96
    (the last one ragged): each train step's loss and grad norm at 1e-4 of
    JAX's chunked loss on the four forced devices and of the port's dense
    loss on the same ranks."""
    jx = runs["jax"]
    for r in runs["ranks"]:
        got, dense = r["2x2"]["chunked"], r["2x2"]["train/full"]
        for k in ("loss", "grad_norm"):
            _close(got[k], jx[f"2x2/chunked/{k}"], TOL, f"{k} vs JAX")
            _close(got[k], dense[k][:CHUNK_STEPS], TOL, f"{k} vs dense")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_loss_runs_on_each_ranks_block_of_the_logits(runs, mesh):
    """The loss never gathers the vocab: no tallied train step (each
    remat, on the 2x2 mesh the chunked loss's too) allocates a tensor of
    the global (B, S, V) shape or the vocab-whole (B / data, S, V) shape
    (the chunked loss: nor a vocab-whole chunk); the loss boundary took
    each rank's (B / data, S, V / model) block (a chunk's columns split
    alike); the loss alone, forward and backward, allocates at most the
    rank's f32 logits block at a time, gives the logits' gradient on
    that block at the logits' placements, and its loss and gradient lie
    at 1e-4 of the loss on the gathered logits."""
    cfg = runs["cfg"]
    data, model = MESHES[mesh]
    V = cfg.vocab
    block = (B // data, S, V // model)
    vocab_whole = {(B, S, V), (B // data, S, V)}
    for r in runs["ranks"]:
        got = r[mesh]
        for step in [f"train/{remat}" for remat in TRAIN[mesh]]:
            assert not vocab_whole & got["made"][step], step
            assert ("lm_loss", (block, block[:2])) in got[step]["calls"]
        if mesh == "2x2":
            assert not vocab_whole & got["made"]["chunked"]
            assert not {(B, S, VOCAB_CHUNK), (B // data, S, VOCAB_CHUNK)} \
                & got["made"]["chunked"]
            chunks = [shapes for name, shapes in got["chunked"]["calls"]
                      if name == "lm_loss_chunk"]
            widths = [VOCAB_CHUNK] * (V // VOCAB_CHUNK) + [V % VOCAB_CHUNK]
            assert set(chunks) == {((B // data, S, w // model), block[:2])
                                   for w in widths}
        lb = got["loss_block"]
        assert not vocab_whole & lb["made"]
        assert lb["local"] == block
        assert lb["placements"][0] == lb["placements"][1]
        assert lb["largest"] <= 4 * B // data * S * V // model
        _close(lb["loss"], lb["plain_loss"], TOL, "loss vs gathered")
        _close(lb["grad"], lb["plain_grad"], TOL, "grad vs gathered")


def test_cuda_launchers_refuse_dtensors(runs):
    """A DTensor never reaches a CUDA launch: each launcher refuses one
    before reading a pointer (the ops hand them local shards)."""
    for r in runs["ranks"]:
        for name, msg in r["2x2"]["guards"].items():
            assert "DTensor operand reached a CUDA launch" in msg, name


def test_checkpoint_written_across_ranks_restores_everywhere(runs, tmp_path):
    """The four ranks' checkpoint of the trained 2x2 params and AdamW
    state: restored on the mesh with ``shardings`` as DTensors of the
    rules' placements holding the same shards; restored on one device by
    the port and by the JAX package's ``CheckpointManager``, bit for bit
    the params the ranks gathered."""
    import jax
    from repro.train.checkpoint import CheckpointManager as JaxManager
    from repro_torch.train.checkpoint import CheckpointManager
    for r in runs["ranks"]:
        back = r["2x2"]["restore"]
        assert back["placed"] and back["moments_equal"]
        assert back["step"] == TRAIN_STEPS["2x2"]
        assert back["extra"] == {"step": CKPT_STEP}
    want = runs["ranks"][0]["2x2"]["train/none"]["params"]
    like = runs["params"]
    ckpt = runs["where"] / "ckpt"
    (tp, ts), extra = CheckpointManager(ckpt).restore(
        (like, init_state(like)))
    assert extra == {"step": CKPT_STEP} and int(ts.step) == CKPT_STEP
    for path, t in tree_leaves(tp):
        assert type(t) is torch.Tensor
        assert np.array_equal(_np(t), want["/".join(path)]), path
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    jlike = jax.tree.map(jnp.asarray, nested(
        {"/".join(k): _np(v) for k, v in tree_leaves(like)}, ""))
    (jp, js), jextra = JaxManager(ckpt).restore(
        (jlike, jopt.init_state(jlike)))
    assert jextra == {"step": CKPT_STEP} and int(js.step) == CKPT_STEP
    for path, a in tree_leaves(jax.tree.map(np.asarray, jp)):
        assert np.array_equal(a, want["/".join(path)]), path


def test_remat_recompute_in_a_thread_constrains_as_the_forward(runs):
    """A remat="full" backward run in a thread of its own (an empty
    context): the recompute's ``constrain`` calls (the checkpointed
    function carries the sharding context) are those of the same backward
    run in the forward's thread, one a layer, each with the placements of
    the forward's call, and the grads are the same bits."""
    cfg = runs["cfg"]
    for r in runs["ranks"]:
        got = r["2x2"]["remat_thread"]
        assert got["thread"] == got["main"]
        forward = [c[:3] for c in got["main"] if not c[3]]
        recompute = [c[:3] for c in got["main"] if c[3]]
        assert len(forward) == 2 + 2 * cfg.n_layers
        assert len(recompute) == cfg.n_layers
        assert all(c in forward[1:-1] and c[2] is not None
                   for c in recompute)
        assert got["grads_equal"]


@pytest.mark.parametrize("H,KV,n,r,want", [
    (4, 2, 4, 3, slice(1, 2)),            # one q head a rank, its KV head
    (16, 8, 4, 1, slice(2, 4)),           # whole groups
    (6, 3, 2, 0, [0, 0, 1]),              # 3 q heads across 2 groups
])
def test_kv_heads_of_a_ranks_q_heads(H, KV, n, r, want):
    """The KV heads a rank's q heads read where the rules replicate KV: a
    slice of whole groups or of one head, else an index of one KV head per
    local q head."""
    got = _kv_heads(H, KV, n, r)
    if isinstance(want, slice):
        assert got == want
    else:
        assert got.tolist() == want
