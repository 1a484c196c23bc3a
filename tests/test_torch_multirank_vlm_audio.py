"""Multi-rank execution of the vlm and audio families on four CPU ranks
(gloo), held against JAX's sharded steps on four forced host devices and
against the port's own unmeshed steps.

Reduced llama-3.2-vision-90b cut to 5 layers with a cross layer every 2
(two cross layers fire three times, at layers 0, 2 and 4; layer 4's index
2 clamps to the last one) and reduced musicgen-large (2 layers), both at d
64, 4 q heads and 2 KV heads of 16, 16 image tokens, in f32 from the
reference's seed-0 init with every ``ca_gate`` opened to 0.5 + 0.1 N(0, 1)
first (the init's zeros hide every cross-attention error), run through
``make_prefill``, ``make_serve_step`` and ``make_train_step`` on a
``DeviceMesh`` of four ranks under ``DEFAULT_RULES``:

* the (2, 2) ("data", "model") mesh: each rank holds 2 of the 4 sequences,
  2 of the 4 q heads and 1 of the 2 KV heads, of the self-attention, the
  cross-attention and the image K/V;
* the (1, 4) mesh: one q head a rank; the 2 KV heads do not divide by 4,
  so the image K/V are whole on every rank and each q head reads its
  group's.

The vlm decodes from a state that ``init_decode_state`` builds from the
DTensor params and a plain (global) image; its self-attention cache, and
audio's, are random bf16 (drawn with numpy) at position 4.  Audio takes
bf16 frame embeddings, in the prefill, each decode step and the train
batches.  JAX runs audio's steps op by op (``jax.disable_jit``): the
reference's jitted scan refuses a carry whose type changes, which bf16
frames into f32 layers make (tests/test_torch_vlm_audio.py).

Held: each rank's local shard of every param leaf and of the random decode
state equals JAX's addressable shard bit for bit; the image K/V that each
side computes from the same sharded weights and image have the placements
of ``CACHE_AXES["img_kv"]`` (JAX's addressable shards' shapes) and agree
at 1e-5 (two frameworks' f32 products); prefill logits (with and without
an image), decode logits, two AdamW steps' losses and grad norms at 1e-4
against JAX's sharded steps (decode at 1e-3: a bf16 cache under f32
weights, as tests/test_torch_vlm_audio.py holds it) and the port's
unmeshed ones, the final
params at 1e-3 of each leaf's largest magnitude (``_held_params``); audio's
``embed``, which ``inputs_embeds`` bypasses, gets a zero gradient at its
own placements; the flash boundary ran the cross-attention on each rank's
batch rows and heads, in prefill and in decode; each step's collectives on
a rank equal, in calls and bytes by kind, the dry-run twin's count of the
same step lowered on that rank's mesh (``Lowered.count``), and so do its
FLOPs and bytes accessed, counted by the same tally
(``roofline.trace.RankTally``) on the same step, its inputs placed before
it as the twin's are; later steps take the global inputs, as a caller
gives them, and place them themselves.

Four ranks and one four-device JAX process start together, under the lock
of the multi-rank test modules.
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
VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
ARCHS = {VLM: {"n_layers": 5}, AUDIO: {}}          # arch -> config changes
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, MAX_SEQ, POS0 = 4, 16, 16, 4     # decode starts at position POS0
DECODE_STEPS, TRAIN_STEPS = 3, 2
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
TOL, PARAM_TOL, IMG_TOL = 1e-4, 1e-3, 1e-5
# decode logits against JAX's: each step's new k / v go into a bf16 cache,
# and two frameworks' f32 products round a value next to a bf16 tie one
# ulp apart (tests/test_torch_vlm_audio.py holds f32 decode against JAX at
# this bound for that reason); against the port's unmeshed steps, TOL
ENGINE_TOL = 1e-3
GATE_SEED = 5
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
    return replace(reduced_config(arch), **ARCHS[arch])


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 (stored as f32: exact on both sides)."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def make_data() -> dict:
    """The inputs every side reads (numpy, from fixed seeds, bf16 values
    held in f32): the vlm's tokens and image, audio's frame embeddings, the
    decode steps' tokens / frames, each model's random self-attention
    cache, and the train batches."""
    d = 64
    rng = np.random.default_rng(1)
    data = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "img": _bf16(rng.normal(size=(B, 16, d))),
            "frames": _bf16(rng.normal(size=(B, S, d))),
            "decode_tokens": rng.integers(
                0, 256, (B, DECODE_STEPS)).astype(np.int32),
            "decode_frames": _bf16(rng.normal(size=(B, DECODE_STEPS, d)))}
    for arch in ARCHS:
        cfg = config(arch)
        shape = (cfg.n_layers, B, MAX_SEQ, cfg.n_kv_heads, cfg.hd)
        for k in ("k", "v"):
            data[f"{arch}/state/{k}"] = _bf16(rng.normal(size=shape))
    for i in range(TRAIN_STEPS):
        r = np.random.default_rng(10 + i)
        data[f"batch{i}/tokens"] = r.integers(0, 256, (B, S)).astype(np.int32)
        data[f"batch{i}/labels"] = r.integers(0, 256, (B, S)).astype(np.int32)
        data[f"batch{i}/img"] = _bf16(r.normal(size=(B, 16, d)))
        data[f"batch{i}/frames"] = _bf16(r.normal(size=(B, S, d)))
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


def bf16(key):
    return jnp.asarray(data[key], jnp.bfloat16)


def run(fn, eager):
    # audio under f32 weights runs op by op: the jitted scan refuses it
    if not eager:
        return jax.jit(fn)

    def call(*args, **kwargs):
        with jax.disable_jit():
            return fn(*args, **kwargs)
    return call


inits = {}
for arch, changes in spec["archs"].items():
    cfg = replace(reduced_config(arch), **changes)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jt.init_params(cfg, jax.random.PRNGKey(0)))
    if "cross" in params:                # open the gates first
        gate = params["cross"]["ca_gate"]
        rng = np.random.default_rng(spec["gate_seed"])
        params["cross"]["ca_gate"] = jnp.asarray(
            0.5 + 0.1 * rng.normal(size=gate.shape), jnp.float32)
    inits[arch] = (cfg, params)
    np.savez(os.path.join(where, f"{arch}.tmp.npz"),
             **{k: host(v) for k, v in flat(params)})
    os.replace(os.path.join(where, f"{arch}.tmp.npz"),
               os.path.join(where, f"{arch}.npz"))
for arch, (cfg, params) in inits.items():
    eager = cfg.family == "audio"
    for name, shape in spec["meshes"].items():
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        tag = f"{arch}/{name}"

        def put(x, names):
            return jax.device_put(x, logical_sharding(names, x.shape, mesh,
                                                      DEFAULT_RULES))
        jp = jax.device_put(params, shardings_for(jt.build_specs(cfg), mesh,
                                                  DEFAULT_RULES))
        for k, v in flat(jp):
            shards(tag, f"param/{k}", v, mesh)
        emb = ("batch", "seq", "act_embed")
        kw = {}
        if cfg.family == "audio":
            kw["inputs_embeds"] = put(bf16("frames"), emb)
        else:
            kw["tokens"] = put(jnp.asarray(data["tokens"]), ("batch", "seq"))
        prefill = run(make_prefill(cfg, mesh, DEFAULT_RULES), eager)
        if cfg.family == "vlm":
            out[f"{tag}/prefill_no_image"] = host(prefill(jp, **kw))
            kw["img_embeds"] = put(bf16("img"), emb)
        out[f"{tag}/prefill"] = host(prefill(jp, **kw))
        # the vlm's image K/V from the sharded params and a plain image
        state = jt.init_decode_state(
            cfg, spec["b"], spec["max_seq"], params=jp,
            img_embeds=bf16("img") if cfg.family == "vlm" else None)
        state = dict(state, pos=jnp.asarray(spec["pos0"], jnp.int32),
                     k=bf16(f"{arch}/state/k"), v=bf16(f"{arch}/state/v"))
        sh = decode_state_shardings(
            cfg, ShapeSpec("state", spec["max_seq"], spec["b"], "decode"),
            mesh, DEFAULT_RULES)
        state = jax.device_put(state, {k: sh[k] for k in state})
        for k in ("pos", "k", "v"):
            shards(tag, f"state/{k}", state[k], mesh)
        for k, v in zip("kv", state.get("img_kv", ())):
            shards(tag, f"img_kv/{k}", v, mesh)
        step = run(make_serve_step(cfg, mesh, DEFAULT_RULES), eager)
        logits = []
        for i in range(spec["decode_steps"]):
            if cfg.family == "audio":
                x = {"inputs_embeds": put(bf16("decode_frames")[:, i:i + 1],
                                          emb)}
            else:
                x = {"tokens": put(jnp.asarray(
                    data["decode_tokens"][:, i:i + 1]), ("batch", "seq"))}
            lg, state = step(jp, state, **x)
            logits.append(host(lg))
        out[f"{tag}/decode"] = np.stack(logits)
        tstep = run(make_train_step(cfg, jopt.AdamWConfig(**spec["opt"]),
                                    mesh, DEFAULT_RULES, remat="full"), eager)
        p, o = jp, jopt.init_state(jp)
        losses, norms = [], []
        for i in range(spec["train_steps"]):
            batch = {"labels": put(jnp.asarray(data[f"batch{i}/labels"]),
                                   ("batch", "seq"))}
            if cfg.family == "audio":
                batch["inputs_embeds"] = put(bf16(f"batch{i}/frames"), emb)
            else:
                batch["tokens"] = put(jnp.asarray(data[f"batch{i}/tokens"]),
                                      ("batch", "seq"))
                batch["img_embeds"] = put(bf16(f"batch{i}/img"), emb)
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
    return {"archs": ARCHS, "meshes": MESHES, "pos0": POS0, "b": B,
            "max_seq": MAX_SEQ, "decode_steps": DECODE_STEPS,
            "train_steps": TRAIN_STEPS, "opt": OPT, "gate_seed": GATE_SEED}


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


def _t(data, key, bf16=False):
    t = torch.from_numpy(data[key])
    return t.bfloat16() if bf16 else t


def _prefill_inputs(cfg, data) -> dict:
    if cfg.family == "audio":
        return {"inputs_embeds": _t(data, "frames", True)}
    return {"tokens": _t(data, "tokens"), "img_embeds": _t(data, "img", True)}


def _step_input(cfg, data, i) -> dict:
    if cfg.family == "audio":
        return {"inputs_embeds": _t(data, "decode_frames", True)[:, i:i + 1]}
    return {"tokens": _t(data, "decode_tokens")[:, i:i + 1]}


def _batch(cfg, data, i) -> dict:
    b = {"labels": _t(data, f"batch{i}/labels")}
    if cfg.family == "audio":
        b["inputs_embeds"] = _t(data, f"batch{i}/frames", True)
    else:
        b["tokens"] = _t(data, f"batch{i}/tokens")
        b["img_embeds"] = _t(data, f"batch{i}/img", True)
    return b


def _state(cfg, arch, data, params) -> dict:
    """The decode state: the vlm's image K/V from ``params`` (DTensors
    across ranks) and the plain global image, the random self-attention
    cache at ``POS0``."""
    img = _t(data, "img", True) if cfg.family == "vlm" else None
    state = init_decode_state(cfg, B, MAX_SEQ, device="cpu", params=params,
                              img_embeds=img)
    state.update(pos=POS0, k=_t(data, f"{arch}/state/k", True),
                 v=_t(data, f"{arch}/state/v", True))
    return state


def _load_params(where, arch):
    path = os.path.join(where, f"{arch}.npz")
    while not os.path.exists(path):
        time.sleep(0.05)                 # the JAX side writes the init
    return params_from_jax(nested(dict(np.load(path)), ""), "cpu")


def twin(cfg, kind: str, seq: int, mesh):
    """The dry-run twin of a step of ``kind`` at (B, ``seq``) on ``mesh``
    under ``DEFAULT_RULES``, f32 params, counted (``Lowered.count``); a
    vlm decode state's image K / V in f32, as f32 params make them (the
    lowered state's are bf16, as bf16 params make them)."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.models.config import ShapeSpec
    from repro_torch.sharding import DEFAULT_RULES
    low = lower_step(cfg, ShapeSpec(f"twin_{kind}", seq, B, kind), mesh,
                     DEFAULT_RULES)
    if kind == "decode" and cfg.family == "vlm":
        params, state, x = low.args
        low.args = (params, dict(state, img_kv=tuple(
            t.float() for t in state["img_kv"])), x)
    return low.count(torch.float32)


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
    from repro_torch.sharding import (DEFAULT_RULES, distribute_inputs,
                                      distribute_tree, sharding_ctx,
                                      shardings_for)
    from repro_torch.train.train_step import make_value_and_grad
    cfg = config(arch)
    params = _load_params(where, arch)
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        r = out[name] = {"coord": tuple(mesh.get_coordinate())}
        psh = shardings_for(build_specs(cfg), mesh, DEFAULT_RULES)
        dp = distribute_tree(params, psh)
        r["shards"] = {f"param/{'/'.join(p)}": _np(t.to_local())
                       for p, t in tree_leaves(dp)}
        prefill = make_prefill(cfg, mesh, DEFAULT_RULES)
        kw = _prefill_inputs(cfg, data)
        # step -> (measured, twin); the tallied steps take their inputs
        # placed, as the twin does
        comm, cost = r["comm"], r["cost"] = {}, {}
        x, tallied = step_inputs(0, kw, mesh, DEFAULT_RULES)
        with shard_calls() as calls, tallied as tally:
            logits = prefill(dp, **x)
        r["prefill"] = _full(logits)
        r["prefill_calls"] = calls
        comm["prefill"], cost["prefill"] = held(
            tally, twin(cfg, "prefill", S, mesh))
        if cfg.family == "vlm":
            r["prefill_no_image"] = _full(prefill(dp, tokens=kw["tokens"]))
        state = _state(cfg, arch, data, dp)
        if cfg.family == "vlm":
            r["img_kv"] = {k: {"local": _np(t.to_local()),
                               "placements": tuple(map(repr, t.placements))}
                           for k, t in zip("kv", state["img_kv"])}
        placed = distribute_state(cfg, state, mesh, DEFAULT_RULES)
        r["shards"].update({f"state/{k}": _np(placed[k].to_local())
                            for k in ("pos", "k", "v")})
        step = make_serve_step(cfg, mesh, DEFAULT_RULES)
        state, logits = dict(placed, pos=POS0), []
        with shard_calls() as calls:
            for i in range(DECODE_STEPS):
                x, tallied = step_inputs(i, _step_input(cfg, data, i), mesh,
                                         DEFAULT_RULES)
                with tallied as tally:
                    lg, state = step(dp, state, **x)
                if i == 0:
                    first = tally
                logits.append(_full(lg))
        r["decode"], r["decode_calls"] = np.stack(logits), calls
        comm["decode"], cost["decode"] = held(
            first, twin(cfg, "decode", MAX_SEQ, mesh))
        if cfg.family == "audio":        # the embedding the frames bypass
            vg = make_value_and_grad(cfg, remat="full")
            batch = distribute_inputs(_batch(cfg, data, 0), mesh,
                                      DEFAULT_RULES)
            with sharding_ctx(mesh, DEFAULT_RULES):
                _, grads = vg(dp, batch)
            g = grads["embed"]
            r["embed_grad"] = {
                "placed": isinstance(g, DTensor)
                and g.placements == dp["embed"].placements,
                "zero": not bool(g.to_local().any())}
        train = make_train_step(cfg, AdamWConfig(**OPT), mesh,
                                DEFAULT_RULES, remat="full")
        p = distribute_tree(params, psh)
        o = init_state(p)
        losses, norms, calls = [], [], None
        for i in range(TRAIN_STEPS):
            batch, tallied = step_inputs(i, _batch(cfg, data, i), mesh,
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
            "params": {"/".join(k): _full(v) for k, v in tree_leaves(p)}}


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
    where = tmp_path_factory.mktemp("multirank_vlm_audio")
    data = make_data()
    np.savez(where / "data.npz", **data)
    with one_rank_group():
        jax_proc = _start_jax(where)
        try:
            ranks = run_ranks(rank_work, WORLD, str(where), device="cpu",
                              timeout=300)
        finally:
            out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0 and "JAX_DONE" in out, err[-4000:]
    jx = dict(np.load(where / "jax.npz"))
    plain = {arch: _unmeshed(config(arch), _load_params(where, arch), arch,
                             data) for arch in ARCHS}
    return {"ranks": ranks, "jax": jx, "plain": plain, "data": data}


def _unmeshed(cfg, params, arch, data) -> dict:
    """The port's steps on the CPU without a mesh: the second reference;
    the train steps' grads too (``_held_params`` reads them)."""
    from repro_torch.train.train_step import make_value_and_grad
    prefill = make_prefill(cfg, "cpu")
    kw = _prefill_inputs(cfg, data)
    out = {"prefill": _np(prefill(params, **kw))}
    if cfg.family == "vlm":
        out["prefill_no_image"] = _np(prefill(params, tokens=kw["tokens"]))
    step = make_serve_step(cfg, "cpu")
    state, logits = _state(cfg, arch, data, params), []
    for i in range(DECODE_STEPS):
        lg, state = step(params, state, **_step_input(cfg, data, i))
        logits.append(_np(lg))
    out["decode"] = np.stack(logits)
    train = make_train_step(cfg, AdamWConfig(**OPT), remat="full")
    grad = make_value_and_grad(cfg, remat="full")
    p = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
             else v.clone()) for k, v in params.items()}
    o = init_state(p)
    r = out["train"] = {"loss": [], "grad_norm": [], "grads": []}
    for i in range(TRAIN_STEPS):
        r["grads"].append({"/".join(k): _np(g) for k, g in tree_leaves(
            grad(p, _batch(cfg, data, i))[1])})
        p, o, m = train(p, o, _batch(cfg, data, i))
        r["loss"].append(float(m["loss"]))
        r["grad_norm"].append(float(m["grad_norm"]))
    r["params"] = {"/".join(k): _np(v) for k, v in tree_leaves(p)}
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

CASES = [(a, m) for a in ARCHS for m in sorted(MESHES)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_shards_equal_jax_addressable_shards(runs, arch, mesh):
    """Each rank's local shard of every param leaf (the opened gates too)
    and of the random decode state (``pos``, the bf16 self-attention k /
    v) equals JAX's addressable shard at the rank's (data, model)
    coordinate, bit for bit."""
    jx = runs["jax"]
    coords = set()
    n_leaves = len(list(tree_leaves(build_specs(config(arch)))))
    for r in runs["ranks"]:
        assert r["backend"] == "gloo"
        got = r[arch][mesh]
        coords.add(got["coord"])
        i, j = got["coord"]
        assert len(got["shards"]) == n_leaves + 3
        for key, local in got["shards"].items():
            want = jx[f"{arch}/{mesh}/shard/{key}/{i}{j}"]
            assert local.shape == want.shape, (key, local.shape, want.shape)
            assert np.array_equal(local, want), key
    assert len(coords) == WORLD


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_image_kv_placed_as_the_cache_axes_give_it(runs, mesh):
    """``init_decode_state`` on DTensor params and a plain global image:
    each rank's image K and V are placed as ``CACHE_AXES["img_kv"]`` gives
    them (batch over "data", KV heads over "model" where they divide, the
    stack of cross layers whole; a mesh dimension of size 1 keeps its
    ``Shard``, as the rules map it), their local blocks have the shapes of
    JAX's addressable shards and agree with them at 1e-5."""
    jx = runs["jax"]
    data, model = MESHES[mesh]
    cfg = config(VLM)
    kv_split = cfg.n_kv_heads % model == 0 and model > 1
    want_place = ("Shard(dim=1)",
                  "Shard(dim=3)" if kv_split else "Replicate()")
    n_ca = cfg.n_layers // cfg.cross_attn_every
    for r in runs["ranks"]:
        got = r[VLM][mesh]
        i, j = got["coord"]
        for k in "kv":
            blk = got["img_kv"][k]
            assert blk["placements"] == want_place, blk["placements"]
            want = jx[f"{VLM}/{mesh}/shard/img_kv/{k}/{i}{j}"]
            assert blk["local"].shape == want.shape == (
                n_ca, B // data, cfg.n_image_tokens,
                cfg.n_kv_heads // (model if kv_split else 1), cfg.hd)
            _close(blk["local"], want, IMG_TOL, f"img_kv {k}")


@pytest.mark.parametrize("arch,mesh", CASES)
def test_prefill_and_decode_match_jax_and_unmeshed(runs, arch, mesh):
    """The prefill logits (the vlm's with its image and without one: zeros
    placed as an image) and each decode step's logits (the vlm on the image
    state, audio on frame embeddings) at 1e-4 against JAX's sharded steps
    (decode at ``ENGINE_TOL``) and the port's unmeshed ones; every rank
    gathers the same logits."""
    jx, plain = runs["jax"], runs["plain"][arch]
    first = runs["ranks"][0][arch][mesh]
    keys = ["prefill", "decode"] + (["prefill_no_image"] if arch == VLM
                                    else [])
    for r in runs["ranks"]:
        for k in keys:
            assert np.array_equal(r[arch][mesh][k], first[k]), k
    tag = f"{arch}/{mesh}"
    assert first["prefill"].shape == (B, S, 256)
    assert first["decode"].shape == (DECODE_STEPS, B, 1, 256)
    for k in keys:
        _close(first[k], jx[f"{tag}/{k}"],
               ENGINE_TOL if k == "decode" else TOL, f"{k} vs JAX")
        _close(first[k], plain[k], TOL, f"{k} vs unmeshed")
    if arch == VLM:                      # the image reaches the logits
        assert np.abs(first["prefill"] - first["prefill_no_image"]).max() \
            > 100 * TOL


def _held_params(got: dict, want: dict, grads: list) -> None:
    """Each leaf within 1e-3 of its largest magnitude, but for the elements
    whose unmeshed gradient at some step is nonzero and within the grads'
    own tolerance (1e-4 of the leaf's largest gradient) of zero: rounding
    decides their sign, and AdamW's bias-corrected step moves such an
    element by about the learning rate whatever its size, so two correct
    runs may move it opposite ways.  Those are held within twice the
    learning rate a step, and may be one element of the leaf, or one in a
    hundred (tests/test_torch_multirank_ssm.py)."""
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
    """Each AdamW step's loss and grad norm (remat "full"; the vlm's
    batches carry images, audio's frame embeddings) at 1e-4 against JAX's
    sharded steps and the port's unmeshed ones, the final params at 1e-3
    of each leaf's largest magnitude (``_held_params``); the ranks agree."""
    jx, plain = runs["jax"], runs["plain"][arch]["train"]
    got = runs["ranks"][0][arch][mesh]["train"]
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


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_audio_embed_gets_zero_grads_at_its_placements(runs, mesh):
    """Audio's frame embeddings bypass the token embedding: across ranks
    its gradient is zeros, a DTensor at the param's own placements (as
    ``jax.value_and_grad`` gives a param the loss does not reach)."""
    for r in runs["ranks"]:
        assert r[AUDIO][mesh]["embed_grad"] == {"placed": True,
                                                "zero": True}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cross_attention_ran_on_local_shards(runs, mesh):
    """The vlm's flash calls took each rank's shards: the prefill's 5
    self-attention and 3 cross-attention calls, and the train step's (its
    forward and its recompute), with q (B / data, 16, H / model, hd) and k
    / v (B / data, 16, KV / model, hd) (the 16 positions or the 16 image
    tokens; on 1x4 the q head's own KV head); in each decode step the 3
    cross calls with one query row over the image."""
    cfg = config(VLM)
    data, model = MESHES[mesh]
    bl, hl = B // data, cfg.n_heads // model
    kvl = max(cfg.n_kv_heads // model, 1)
    local = ((bl, S, hl, cfg.hd),) + ((bl, cfg.n_image_tokens, kvl,
                                       cfg.hd),) * 2
    fired = -(-cfg.n_layers // cfg.cross_attn_every)
    assert cfg.n_image_tokens == S and fired == 3
    for r in runs["ranks"]:
        got = r[VLM][mesh]
        pre = [s for n, s in got["prefill_calls"] if n == "flash_attention"]
        assert pre == [local] * (cfg.n_layers + fired)
        train = [s for n, s in got["train"]["calls"]
                 if n == "flash_attention"]
        assert train and set(train) == {local}
        dec = [s for n, s in got["decode_calls"] if n == "flash_attention"]
        assert dec == [((bl, 1, hl, cfg.hd),) + local[1:]] \
            * (DECODE_STEPS * fired)
