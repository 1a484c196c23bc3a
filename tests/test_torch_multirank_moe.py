"""Multi-rank execution of the MoE family on four CPU ranks (gloo), held
against JAX's sharded steps on four forced host devices and against the
port's own unmeshed steps.

Reduced granite-moe-3b-a800m (tied head) and qwen3-moe-30b-a3b (qk_norm,
untied head): 2 layers, d 64, 4 experts, top-2, in f32 from the
reference's seed-0 init, both sides' configs given ``capacity_factor`` 0.5
so that the prefill and the train steps drop tokens (T = 64 pairs of
tokens a batch, C = 16 rows an expert for 128 choices).  They run through
``make_prefill``, ``make_serve_step`` and ``make_train_step`` on a
``DeviceMesh`` of four ranks (``CASES``):

* the (2, 2) ("data", "model") mesh under ``DEFAULT_RULES``: 2 experts a
  rank, the capacity whole;
* the (1, 4) mesh: 1 expert a rank;
* ``ep_capacity`` on (2, 2): 2 experts and half the capacity a rank;
* ``expert_data`` on (2, 2): the experts over ("data", "model"), 1 a rank;
* ``ep_only`` on (2, 2) (granite): experts over "model", attention and the
  head unsharded by the model axis, FSDP over both.

Held: the inputs have no router tie at the k-th place, and the prefill
drops tokens that a route of each data rank's rows alone would not (so a
per-rank route would show); each rank's local shard of every param and
decode-state leaf equals JAX's addressable shard bit for bit; each rank's
routes equal the unmeshed ones; prefill and decode logits, losses (with
the aux loss), aux losses and grad norms at 1e-4, final params at 1e-3 of
each leaf's largest magnitude, against JAX's sharded steps and the port's
unmeshed ones; the boundary's local operand shapes (``shard_calls()``);
the chunked loss with the aux loss across ranks; one bf16 prefill against
the port's unmeshed bf16 prefill, its routes equal.  (Compiled JAX bf16
MoE routes differently from its own op-by-op run, ROADMAP Queue 3: the
bf16 case holds the port to itself.)  Each step's collectives on a rank
equal, in calls and bytes by kind, the dry-run twin's count of the same
step lowered on that rank's mesh (``Lowered.count``), and so do its FLOPs
and bytes accessed, counted by the same tally
(``roofline.trace.RankTally``) on the same step, its inputs placed before
it as the twin's are (the route log's own work left out of the tally);
later steps take the global batch or tokens, as a caller gives them, and
place them themselves.

The ranks run in processes of their own (``launch.ranks.run_ranks``,
spawned, one torch thread each); the JAX side runs in a subprocess with four
forced host devices.  Both start together once for the module, under the
lock that the other multi-rank modules take, so that one group of four
ranks at a time loads the host.
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
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import moe as tm
from repro_torch.models.params import tree_leaves
from repro_torch.models.transformer import build_specs
from repro_torch.serve.serve_step import make_prefill, make_serve_step
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b")
WORLD = 4
CAPACITY_FACTOR = 0.5
# case -> (mesh shape, rules variant, archs)
CASES = {"2x2": ((2, 2), "baseline", ARCHS),
         "1x4": ((1, 4), "baseline", ARCHS),
         "2x2_ep_capacity": ((2, 2), "ep_capacity", ARCHS[:1]),
         "2x2_expert_data": ((2, 2), "expert_data", ARCHS[:1]),
         "2x2_ep_only": ((2, 2), "ep_only", ARCHS[:1])}
RUNS = [(arch, case) for case, (_, _, archs) in CASES.items()
        for arch in archs]
B, S, MAX_SEQ, POS0 = 4, 16, 16, 4     # decode starts at position POS0
DECODE_STEPS, TRAIN_STEPS = 3, 2
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
TOL, PARAM_TOL = 1e-4, 1e-3
# the chunked loss with the aux loss: granite on the 2x2 mesh, the vocab
# in chunks of 96 (the last one ragged)
CHUNK_ARCH, VOCAB_CHUNK = ARCHS[0], 96
# bf16 prefill against the port's unmeshed bf16 prefill (LOGITS_ATOL /
# LOGITS_RTOL of chip_smoke.py: the ranks round the attention output's
# and the experts' partial sums in bf16 at other places)
BF16_ARCH, BF16_ATOL, BF16_RTOL = ARCHS[0], 0.15, 0.05
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


def config(arch):
    return replace(reduced_config(arch), capacity_factor=CAPACITY_FACTOR)


def make_data() -> dict:
    """The inputs every side reads (numpy, from fixed seeds): tokens for the
    prefill, a decode state of random k / v (drawn in f32, rounded to bf16
    by each side) with its decode tokens, and the train batches."""
    cfg = config(ARCHS[0])
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    rng = np.random.default_rng(2)
    data = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32),
            "state_k": rng.normal(size=(L, B, MAX_SEQ, KV, hd)).astype(
                np.float32),
            "state_v": rng.normal(size=(L, B, MAX_SEQ, KV, hd)).astype(
                np.float32),
            "decode_tokens": np.random.default_rng(3).integers(
                0, cfg.vocab, (B, DECODE_STEPS)).astype(np.int32)}
    for i in range(TRAIN_STEPS):
        toks = np.random.default_rng(10 + i).integers(0, cfg.vocab, (B, S + 1))
        data[f"batch{i}"] = toks.astype(np.int32)
    return data


def nested(flat: dict, prefix: str) -> dict:
    """``{"p/a/b": x}`` under ``prefix`` "p/" -> ``{"a": {"b": x}}``."""
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
import dataclasses, functools, os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import reduced_config
from repro.launch.variants import apply_variant
from repro.models import transformer as jt
from repro.models.config import ShapeSpec
from repro.serve.serve_step import (decode_state_shardings, make_prefill,
                                    make_serve_step)
from repro.sharding import DEFAULT_RULES, logical_sharding, shardings_for
from repro.train import optimizer as jopt
import repro.train.train_step as jts

where = sys.argv[1]
spec = __import__("json").loads(os.environ["MULTIRANK_SPEC"])
assert jax.device_count() == 4, jax.devices()
data = dict(np.load(os.path.join(where, "data.npz")))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def host(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


cfgs, params = {}, {}
for arch in spec["archs"]:
    cfgs[arch] = dataclasses.replace(reduced_config(arch),
                                     capacity_factor=spec["capacity_factor"])
    params[arch] = jax.tree.map(lambda a: a.astype(jnp.float32),
                                jt.init_params(cfgs[arch],
                                               jax.random.PRNGKey(0)))
np.savez(os.path.join(where, "params.tmp.npz"),
         **{f"{arch}/{k}": host(v) for arch in spec["archs"]
            for k, v in flat(params[arch])})
os.replace(os.path.join(where, "params.tmp.npz"),
           os.path.join(where, "params.npz"))
out = {}


def shards(name, key, arr, mesh):
    for i in range(mesh.devices.shape[0]):
        for j in range(mesh.devices.shape[1]):
            dev = mesh.devices[i, j]
            (sh,) = [s for s in arr.addressable_shards if s.device == dev]
            out[f"{name}/shard/{key}/{i}{j}"] = host(sh.data)


def train(name, cfg, mesh, rules, jp, loss_impl="dense"):
    tstep = jax.jit(jts.make_train_step(
        cfg, jopt.AdamWConfig(**spec["opt"]), mesh, rules, remat="full",
        loss_impl=loss_impl))
    p, o = jp, jopt.init_state(jp)
    losses, norms = [], []
    for i in range(spec["train_steps"]):
        toks = data[f"batch{i}"]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batch = jax.device_put(batch, {k: logical_sharding(
            ("batch", "seq"), v.shape, mesh, rules)
            for k, v in batch.items()})
        p, o, m = tstep(p, o, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{name}/loss"] = np.asarray(losses)
    out[f"{name}/grad_norm"] = np.asarray(norms)
    return p


for arch, case in spec["runs"]:
    cfg, name = cfgs[arch], f"{arch}/{case}"
    shape, variant, _ = spec["cases"][case]
    rules = apply_variant(DEFAULT_RULES, arch, "train_4k", variant)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    psh = shardings_for(jt.build_specs(cfg), mesh, rules)
    jp = jax.device_put(params[arch], psh)
    for k, v in flat(jp):
        shards(name, f"param/{k}", v, mesh)
    toks = jax.device_put(data["tokens"], logical_sharding(
        ("batch", "seq"), data["tokens"].shape, mesh, rules))
    out[f"{name}/prefill"] = host(jax.jit(make_prefill(cfg, mesh, rules))(
        jp, toks))
    state = {"pos": jnp.asarray(spec["pos0"], jnp.int32),
             "k": jnp.asarray(data["state_k"], jnp.bfloat16),
             "v": jnp.asarray(data["state_v"], jnp.bfloat16)}
    B, S = data["state_k"].shape[1:3]
    state = jax.device_put(state, decode_state_shardings(
        cfg, ShapeSpec("state", S, B, "decode"), mesh, rules))
    for k, v in state.items():
        shards(name, f"state/{k}", v, mesh)
    step = jax.jit(make_serve_step(cfg, mesh, rules))
    logits = []
    for i in range(spec["decode_steps"]):
        lg, state = step(jp, state, data["decode_tokens"][:, i:i + 1])
        logits.append(host(lg))
    out[f"{name}/decode"] = np.stack(logits)
    p = train(f"{name}/train", cfg, mesh, rules, jp)
    for k, v in flat(p):
        out[f"{name}/train/param/{k}"] = host(v)
    if arch == spec["chunk_arch"] and case == "2x2":
        # the chunked loss at a ragged chunk: the train step's module-level
        # lm_loss_chunked, given the chunk (the reference takes no argument)
        real = jts.lm_loss_chunked
        jts.lm_loss_chunked = functools.partial(
            real, vocab_chunk=spec["vocab_chunk"])
        train(f"{name}/chunked", cfg, mesh, rules, jp, "chunked")
        jts.lm_loss_chunked = real
np.savez(os.path.join(where, "jax.npz"), **out)
print("JAX_DONE")
"""


def _spec() -> dict:
    return {"archs": ARCHS, "runs": RUNS, "cases": CASES,
            "capacity_factor": CAPACITY_FACTOR, "pos0": POS0,
            "decode_steps": DECODE_STEPS, "train_steps": TRAIN_STEPS,
            "opt": OPT, "chunk_arch": CHUNK_ARCH, "vocab_chunk": VOCAB_CHUNK}


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


def _state(data) -> dict:
    return {"pos": POS0,
            "k": torch.from_numpy(data["state_k"]).to(torch.bfloat16),
            "v": torch.from_numpy(data["state_v"]).to(torch.bfloat16)}


def _batch(data, i) -> dict:
    toks = torch.from_numpy(data[f"batch{i}"])
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _params(where, arch) -> dict:
    return params_from_jax(nested(dict(np.load(
        os.path.join(where, "params.npz"))), f"{arch}/"), "cpu")


@contextlib.contextmanager
def routes():
    """Inside: every MoE ``route`` call's expert ids (sorted, (T, k)) and
    router logits (T, E), in call order."""
    real, log = tm.route, []

    def spy(h, router, k):
        probs, top_p, top_i = real(h, router, k)
        with _disable_current_modes():       # no tally counts the log
            log.append((top_i.sort(dim=-1).values, (h @ router).float()))
        return probs, top_p, top_i
    tm.route = spy
    try:
        yield log
    finally:
        tm.route = real


def twin(cfg, kind: str, mesh, rules, dtype=torch.float32, **kw):
    """The dry-run twin of a step of ``kind`` at (B, S) on ``mesh`` under
    ``rules``, ``dtype`` params, counted (``Lowered.count``)."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.models.config import ShapeSpec
    seq = MAX_SEQ if kind == "decode" else S
    return lower_step(cfg, ShapeSpec(f"twin_{kind}", seq, B, kind), mesh,
                      rules, **kw).count(dtype)


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


def _train(cfg, mesh, rules, params, psh, data, **kw) -> dict:
    """``TRAIN_STEPS`` train steps from the placed params: losses, aux
    losses of the first step's forward, grad norms, final params, and the
    first step's collectives and cost beside its twin's (``comm``,
    ``cost``)."""
    from repro_torch.sharding import distribute_tree
    step = make_train_step(cfg, AdamWConfig(**OPT), mesh, rules,
                           remat="full", **kw)
    p = distribute_tree(params, psh)
    o = init_state(p)
    out = {"loss": [], "grad_norm": []}
    for i in range(TRAIN_STEPS):
        batch, tallied = step_inputs(i, _batch(data, i), mesh, rules)
        with tallied as tally:
            p, o, m = step(p, o, batch)
        if i == 0:
            out["comm"], out["cost"] = held(
                tally, twin(cfg, "train", mesh, rules, **kw))
        out["loss"].append(float(m["loss"].full_tensor()))
        out["grad_norm"].append(float(m["grad_norm"].full_tensor()))
    out["params"] = {"/".join(k): _full(v) for k, v in tree_leaves(p)}
    return out


def rank_work(rank: int, where: str) -> dict:
    """One rank's share of every check (``runs`` reads the results)."""
    import torch.distributed as dist
    from repro_torch.kernels._local import shard_calls
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models.transformer import forward
    from repro_torch.serve.serve_step import distribute_state
    from repro_torch.sharding import (DEFAULT_RULES, distribute_inputs,
                                      distribute_tree, sharding_ctx,
                                      shardings_for)
    from repro_torch.roofline.trace import RankTally
    torch.set_num_threads(1)
    while not os.path.exists(os.path.join(where, "params.npz")):
        time.sleep(0.05)                 # the JAX side writes the init
    data = dict(np.load(os.path.join(where, "data.npz")))
    out = {"backend": dist.get_backend()}
    meshes = {}
    for arch, case in RUNS:
        shape, variant, _ = CASES[case]
        cfg, params = config(arch), _params(where, arch)
        rules = apply_variant(DEFAULT_RULES, arch, "train_4k", variant)
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        r = out[f"{arch}/{case}"] = {"coord": tuple(mesh.get_coordinate())}
        psh = shardings_for(build_specs(cfg), mesh, rules)
        dp = distribute_tree(params, psh)
        r["shards"] = {f"param/{'/'.join(p)}": _np(t.to_local())
                       for p, t in tree_leaves(dp)}
        tokens = torch.from_numpy(data["tokens"])
        # step -> (measured, twin); the tallied steps take their inputs
        # placed, as the twin does
        comm, cost = r["comm"], r["cost"] = {}, {}
        placed_tokens = distribute_inputs({"tokens": tokens}, mesh,
                                          rules)["tokens"]
        with shard_calls() as calls, routes() as log, \
                RankTally() as tally:
            logits = make_prefill(cfg, mesh, rules)(dp, tokens=placed_tokens)
        r["prefill"] = _full(logits)
        comm["prefill"], cost["prefill"] = held(
            tally, twin(cfg, "prefill", mesh, rules))
        r["prefill_calls"] = calls
        r["prefill_routes"] = [ids.numpy() for ids, _ in log]
        with torch.no_grad(), sharding_ctx(mesh, rules):
            _, aux = forward(dp, cfg, distribute_inputs(
                {"tokens": tokens}, mesh, rules)["tokens"], remat="none")
        r["aux"] = float(aux.full_tensor())
        r["aux_placements"] = tuple(map(repr, aux.placements))
        placed = distribute_state(cfg, _state(data), mesh, rules)
        r["shards"].update({f"state/{k}": _np(v.to_local())
                            for k, v in placed.items()})
        step = make_serve_step(cfg, mesh, rules)
        state, logits = dict(placed, pos=POS0), []
        with shard_calls() as calls:
            for i in range(DECODE_STEPS):
                x, tallied = step_inputs(i, {"tokens": torch.from_numpy(
                    data["decode_tokens"][:, i:i + 1])}, mesh, rules)
                with tallied as tally:
                    lg, state = step(dp, state, x["tokens"])
                if i == 0:
                    first = tally
                logits.append(_full(lg))
        r["decode"] = np.stack(logits)
        r["decode_calls"] = calls
        comm["decode"], cost["decode"] = held(
            first, twin(cfg, "decode", mesh, rules))
        r["train"] = _train(cfg, mesh, rules, params, psh, data)
        comm["train"] = r["train"].pop("comm")
        cost["train"] = r["train"].pop("cost")
        if arch == CHUNK_ARCH and case == "2x2":
            with ragged_chunks():
                r["chunked"] = _train(cfg, mesh, rules, params, psh, data,
                                      loss_impl="chunked")
            comm["chunked"] = r["chunked"].pop("comm")
            cost["chunked"] = r["chunked"].pop("cost")
        if arch == BF16_ARCH and case == "2x2":
            bp = distribute_tree(params_bf16(params), psh)
            with routes() as log, RankTally() as tally:
                logits = make_prefill(cfg, mesh, rules)(bp,
                                                        tokens=placed_tokens)
            r["bf16_prefill"] = _full(logits)
            r["bf16_routes"] = [ids.numpy() for ids, _ in log]
            comm["bf16_prefill"], cost["bf16_prefill"] = held(tally, twin(
                cfg, "prefill", mesh, rules, dtype=None))
    return out


def params_bf16(params) -> dict:
    from repro_torch.models.params import tree_unflatten
    return tree_unflatten((k, v.to(torch.bfloat16))
                          for k, v in tree_leaves(params))


def _unmeshed(arch, params, data) -> dict:
    """The port's steps on the CPU without a mesh: the second reference,
    with each route call's expert ids and router logits."""
    from repro_torch.models.transformer import forward
    cfg = config(arch)
    tokens = torch.from_numpy(data["tokens"])
    with routes() as log:
        out = {"prefill": _np(make_prefill(cfg, "cpu")(params, tokens))}
    out["prefill_routes"] = log
    with torch.no_grad():
        out["aux"] = float(forward(params, cfg, tokens, remat="none")[1])
    step = make_serve_step(cfg, "cpu")
    state, logits = _state(data), []
    with routes() as log:
        for i in range(DECODE_STEPS):
            lg, state = step(params, state, torch.from_numpy(
                data["decode_tokens"][:, i:i + 1]))
            logits.append(_np(lg))
    out["decode"], out["decode_routes"] = np.stack(logits), log
    for impl in ("train", "chunked"):
        train = make_train_step(cfg, AdamWConfig(**OPT), remat="full",
                                loss_impl="chunked" if impl == "chunked"
                                else "dense")
        p = {k: ({n: t.clone() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
        o = init_state(p)
        r = out[impl] = {"loss": [], "grad_norm": []}
        with routes() as log, ragged_chunks():
            for i in range(TRAIN_STEPS):
                p, o, m = train(p, o, _batch(data, i))
                r["loss"].append(float(m["loss"]))
                r["grad_norm"].append(float(m["grad_norm"]))
        r["routes"] = log
        r["params"] = {"/".join(k): _np(v) for k, v in tree_leaves(p)}
    if arch == BF16_ARCH:
        with routes() as log:
            out["bf16_prefill"] = _np(make_prefill(cfg, "cpu")(
                params_bf16(params), tokens))
        out["bf16_routes"] = [ids.numpy() for ids, _ in log]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's sharded steps and the four ranks (started together, under the
    multi-rank lock), and the port's unmeshed steps on the same weights and
    inputs."""
    from repro_torch.launch.ranks import run_ranks
    where = tmp_path_factory.mktemp("multirank_moe")
    data = make_data()
    np.savez(where / "data.npz", **data)
    with one_rank_group():
        t0 = time.perf_counter()
        jax_proc = _start_jax(where)
        try:
            ranks = run_ranks(rank_work, WORLD, str(where), device="cpu",
                              timeout=600)
        finally:
            out, err = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0 and "JAX_DONE" in out, err[-4000:]
    jx = dict(np.load(where / "jax.npz"))
    plain = {arch: _unmeshed(arch, _params(str(where), arch), data)
             for arch in ARCHS}
    return {"ranks": ranks, "jax": jx, "plain": plain, "data": data,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _kept(top_i: torch.Tensor, C: int) -> torch.Tensor:
    """Which (token, choice) pairs of a route keep a row of their expert's
    ``C`` (the sort-based dispatch's rule: a pair's place in its expert's
    segment of the expert-sorted, token-ordered list)."""
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    pos = torch.arange(flat.numel()) - torch.searchsorted(se, se)
    keep = torch.empty_like(pos, dtype=torch.bool)
    keep[order] = pos < C
    return keep.reshape(top_i.shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_tie_free_and_drop_unlike_a_per_rank_route(runs, arch):
    """Every route call of the unmeshed prefill, decode and train steps has
    no tie between its k-th and (k+1)-th router logit (a tie could order
    differently in JAX and torch).  The prefill's first layer drops pairs
    (capacity factor 0.5), and routing each data rank's rows of the 2 x 2
    mesh alone, with that rank's own capacity, keeps a different set: a
    per-rank route would show in the logits."""
    cfg, plain = config(arch), runs["plain"][arch]
    k = cfg.top_k
    calls = (plain["prefill_routes"] + plain["decode_routes"]
             + plain["train"]["routes"])
    for _, logits in calls:
        srt = torch.sort(logits, dim=-1, descending=True).values
        assert bool((srt[:, k - 1] > srt[:, k]).all()), "router tie at top-k"
    ids, logits = plain["prefill_routes"][0]
    T = ids.shape[0]
    top_i = torch.topk(logits, k, dim=-1).indices
    whole = _kept(top_i, tm.capacity(cfg, T))
    assert not bool(whole.all()), "the prefill drops nothing"
    half = T // 2
    per_rank = torch.cat([_kept(top_i[:half], tm.capacity(cfg, half)),
                          _kept(top_i[half:], tm.capacity(cfg, half))])
    assert not torch.equal(whole, per_rank)


@pytest.mark.parametrize("arch,case", RUNS)
def test_shards_equal_jax_addressable_shards(runs, arch, case):
    """Each rank's local shard of every param leaf and decode-state leaf
    equals JAX's addressable shard at the rank's (data, model) coordinate,
    bit for bit, under the case's rules."""
    jx, name = runs["jax"], f"{arch}/{case}"
    coords = set()
    for r in runs["ranks"]:
        got = r[name]
        assert r["backend"] == "gloo"
        coords.add(got["coord"])
        i, j = got["coord"]
        assert len(got["shards"]) == len(list(tree_leaves(
            build_specs(config(arch))))) + 3
        for key, local in got["shards"].items():
            want = jx[f"{name}/shard/{key}/{i}{j}"]
            assert local.shape == want.shape, (key, local.shape, want.shape)
            assert np.array_equal(local, want), key
    assert len(coords) == WORLD


@pytest.mark.parametrize("arch,case", RUNS)
def test_prefill_and_decode_match_jax_and_unmeshed(runs, arch, case):
    """The prefill's routes on every rank equal the unmeshed ones; the
    prefill logits, the aux loss (a replicated DTensor) and each decode
    step's logits (T = B tokens, C = T: nothing drops) at 1e-4 against
    JAX's sharded steps and the port's unmeshed ones; every rank gathers
    the same logits."""
    jx, plain, name = runs["jax"], runs["plain"][arch], f"{arch}/{case}"
    first = runs["ranks"][0][name]
    want_routes = [ids.numpy() for ids, _ in plain["prefill_routes"]]
    for r in runs["ranks"]:
        got = r[name]
        assert np.array_equal(got["prefill"], first["prefill"])
        assert np.array_equal(got["decode"], first["decode"])
        assert len(got["prefill_routes"]) == len(want_routes)
        for a, b in zip(got["prefill_routes"], want_routes):
            assert np.array_equal(a, b)
        assert got["aux_placements"] == ("Replicate()", "Replicate()")
        _close(got["aux"], plain["aux"], TOL, "aux vs unmeshed")
    _close(first["prefill"], jx[f"{name}/prefill"], TOL, "prefill vs JAX")
    _close(first["prefill"], plain["prefill"], TOL, "prefill vs unmeshed")
    _close(first["decode"], jx[f"{name}/decode"], TOL, "decode vs JAX")
    _close(first["decode"], plain["decode"], TOL, "decode vs unmeshed")


def _held_params(got, want, what):
    for path, t in got.items():
        err = float(np.abs(t - want[path]).max())
        assert err <= PARAM_TOL * max(float(np.abs(want[path]).max()),
                                      1e-30), (path, what, err)


@pytest.mark.parametrize("arch,case", RUNS)
def test_train_steps_match_jax_and_unmeshed(runs, arch, case):
    """Each train step's loss (cross-entropy plus 0.01 times the layers'
    aux loss) and grad norm at 1e-4, the final params at 1e-3 of each
    leaf's largest magnitude, against JAX's sharded steps and the port's
    unmeshed ones; every rank reads the same losses."""
    jx, plain, name = runs["jax"], runs["plain"][arch], f"{arch}/{case}"
    got = runs["ranks"][0][name]["train"]
    for k in ("loss", "grad_norm"):
        _close(got[k], jx[f"{name}/train/{k}"], TOL, f"{k} vs JAX")
        _close(got[k], plain["train"][k], TOL, f"{k} vs unmeshed")
    _held_params(got["params"], {p: jx[f"{name}/train/param/{p}"]
                                 for p in got["params"]}, "JAX")
    _held_params(got["params"], plain["train"]["params"], "unmeshed")
    for r in runs["ranks"][1:]:
        assert r[name]["train"]["loss"] == got["loss"]


def test_chunked_loss_meets_the_aux_loss_across_ranks(runs):
    """granite on the 2x2 mesh with ``loss_impl="chunked"`` (chunks of 96
    columns, the last one ragged) and the aux loss: each step's loss and
    grad norm at 1e-4 of JAX's chunked loss on the four forced devices, of
    the port's unmeshed chunked loss and of its dense loss on the ranks."""
    jx, plain = runs["jax"], runs["plain"][CHUNK_ARCH]
    name = f"{CHUNK_ARCH}/2x2"
    for r in runs["ranks"]:
        got = r[name]["chunked"]
        for k in ("loss", "grad_norm"):
            _close(got[k], jx[f"{name}/chunked/{k}"], TOL, f"{k} vs JAX")
            _close(got[k], plain["chunked"][k], TOL, f"{k} vs unmeshed")
            _close(got[k], r[name]["train"][k], TOL, f"{k} vs dense")


def _split(case):
    """(experts a rank, capacity rows of C a rank) of ``case``'s rules on
    the reduced models (4 experts)."""
    (data, model), variant, _ = CASES[case]
    experts = 4 // (data * model if variant == "expert_data" else model)
    return experts, (lambda C: C // data if variant == "ep_capacity" else C)


@pytest.mark.parametrize("arch,case", RUNS)
def test_boundary_ran_on_local_shards(runs, arch, case):
    """Each MoE layer took the boundary, twice a layer: the route on the
    whole batch's rows (T, d) and the router's expert columns (d, E); the
    experts on the rank's own experts of w_gate / w_up / w_down, their
    embed and ffn dims whole, and its own block of the (E, C, d) dispatch
    buffer (the capacity halved under ``ep_capacity``).  Decode routes B
    tokens with C = B."""
    cfg = config(arch)
    d, E, f, k = cfg.d_model, cfg.n_experts, cfg.d_ff, cfg.top_k
    El, cap = _split(case)
    for r in runs["ranks"]:
        got = r[f"{arch}/{case}"]
        for calls, T in ((got["prefill_calls"], B * S),
                         (got["decode_calls"], B)):
            C = tm.capacity(cfg, T)
            moe = [c for c in calls if c[0].startswith("moe")]
            assert len(moe) == 3 * cfg.n_layers * (1 if T == B * S
                                                   else DECODE_STEPS)
            for name, shapes in moe:
                if name == "moe_route":
                    assert shapes == ((T, d), (d, E)), shapes
                elif name == "moe_buffer":
                    assert shapes == ((El, cap(C), d),), shapes
                else:
                    assert shapes == ((T, d), (T, k), (T, k), (El, d, f),
                                      (El, d, f), (El, f, d)), shapes


@pytest.mark.parametrize("arch,case", RUNS)
def test_twin_counts_the_collectives_each_rank_dispatches(runs, arch, case):
    """The prefill's, the first decode step's and the first train step's
    collectives on each rank (granite on 2x2: the chunked loss's and the
    bf16 prefill's too), in calls and bytes by kind, equal the dry-run
    twin's count of the step lowered on that rank's mesh under the case's
    rules."""
    want = {"prefill", "decode", "train"}
    if (arch, case) == (CHUNK_ARCH, "2x2"):
        want |= {"chunked", "bf16_prefill"}
    for r in runs["ranks"]:
        comm = r[f"{arch}/{case}"]["comm"]
        assert set(comm) == want
        for step, (measured, counted) in comm.items():
            assert measured == counted, (r[f"{arch}/{case}"]["coord"], step)
            assert sum(measured[0].values()) > 0, step


@pytest.mark.parametrize("arch,case", RUNS)
def test_twin_counts_the_flops_and_bytes_each_rank_runs(runs, arch, case):
    """The same tallied steps: each rank's FLOPs and bytes accessed, by
    the tally that counts the twin, equal the twin's (an MoE rank's route
    on the whole batch included on both)."""
    for r in runs["ranks"]:
        got = r[f"{arch}/{case}"]
        assert set(got["cost"]) == set(got["comm"])
        for step, (measured, counted) in got["cost"].items():
            assert measured == counted, (got["coord"], step)
            assert measured[0] > 0 and measured[1] > 0, step


def test_bf16_prefill_matches_the_unmeshed_bf16_prefill(runs):
    """granite in bf16 on the 2x2 mesh: every rank's routes equal the
    unmeshed bf16 prefill's, and its logits lie within LOGITS_ATOL /
    LOGITS_RTOL of them."""
    plain = runs["plain"][BF16_ARCH]
    for r in runs["ranks"]:
        got = r[f"{BF16_ARCH}/2x2"]
        assert len(got["bf16_routes"]) == len(plain["bf16_routes"])
        for a, b in zip(got["bf16_routes"], plain["bf16_routes"]):
            assert np.array_equal(a, b)
        np.testing.assert_allclose(got["bf16_prefill"], plain["bf16_prefill"],
                                   atol=BF16_ATOL, rtol=BF16_RTOL)
