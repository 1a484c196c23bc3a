"""Decode with a KV cache split along its sequence, on four CPU ranks
(gloo), held against JAX's decode under the same rules on four forced host
devices and against the port's own unmeshed decode.

The variants ``cache_seq_model`` and ``decode_weights_stationary``
(``launch.variants``) put the caches' sequence on "model" and leave the KV
heads whole; the second also keeps the weights unsplit along "data".
Reduced qwen3-1.7b (2 layers), zamba2-1.2b cut to 4 layers (its shared
attention block, firing at layers 0 and 2, reads ``shared_k`` /
``shared_v``) and llama-3.2-vision-90b cut to 3 layers (its self-attention
cache; the image K/V have no sequence axis and stay as ``CACHE_AXES``
places them), in f32 from the reference's seed-0 init (the vlm's gates
opened to 0.5 + 0.1 N(0, 1)), decode through ``make_serve_step`` on a
``DeviceMesh`` of four ranks:

* the (2, 2) ("data", "model") mesh: each rank holds 2 of the 4 sequences
  and 4 of the cache's 8 positions ([0, 4) or [4, 8));
* the (1, 4) mesh: 2 positions a rank.

The state is random (every leaf drawn with numpy, bf16 caches) at position
1, so the first step attends over positions 0 and 1 (``kv_len`` 2, inside
the first "model" rank's block: the other ranks hold no valid position,
only random values the mask must drop), and the 5 steps write positions 1
to 5, on two "model" ranks of the (2, 2) mesh and three of the (1, 4).
Both facts are asserted from each rank's local cache.

Held: each rank's local shard of every decode-state leaf against JAX's
addressable shard, as placed and after every step: bit for bit but for
what a step computes (a written k / v within one bf16 ulp, the f32 conv
and SSD states at 1e-4); each step's logits at 1e-4
against JAX's and the port's unmeshed decode; the ranks gather the same
logits; decode attention ran on each rank's own positions with q whole on
"model" (its local operand shapes), and the split-sequence boundary alone
(``seq_on_shards``), on a cache whose invalid positions hold values of
1e4, equals ``decode_attention_ref`` on a clean one; each step's
collectives on a rank equal, in calls and bytes by kind, the dry-run
twin's count of the step lowered on that rank's mesh (``Lowered.count``),
and so do its FLOPs and bytes accessed, counted by the same tally
(``roofline.trace.RankTally``) against a twin that writes the step's own
position.  Those tallied steps take their inputs as the twin does (the
state and tokens placed before the step, the position an int) and run
beside the steps checked against JAX, which take the global state and
tokens as a caller gives them and feed each step's returned state to the
next; both give the same logits.

JAX runs every case: it decodes all three families under both variants.
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
from repro_torch.models.transformer import init_decode_state
from repro_torch.serve.serve_step import make_serve_step

ROOT = Path(__file__).resolve().parent.parent
VLM = "llama-3.2-vision-90b"
ARCHS = {"qwen3-1.7b": {}, "zamba2-1.2b": {"n_layers": 4},
         VLM: {"n_layers": 3}}                     # arch -> config changes
VARIANTS = ("cache_seq_model", "decode_weights_stationary")
WORLD = 4
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, MAX_SEQ, POS0, DECODE_STEPS = 4, 8, 1, 5
TOL = 1e-4
GATE_SEED = 5
# the boundary alone: q (B, 1, H, hd) over a cache of (B, S, KV, hd)
BOUNDARY = dict(b=4, s=8, h=4, kv=2, hd=16, kv_len=2)
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


def state_leaves(cfg) -> dict:
    """The decode state's tensor leaves: name -> (shape, dtype), the image
    K and V as ``img_kv/k`` and ``img_kv/v``."""
    st = init_decode_state(cfg, B, MAX_SEQ, device="meta")
    out = {}
    for k, v in st.items():
        if k == "img_kv":
            out.update({f"img_kv/{n}": (tuple(t.shape), t.dtype)
                        for n, t in zip("kv", v)})
        elif isinstance(v, torch.Tensor):
            out[k] = (tuple(v.shape), v.dtype)
    return out


def make_data() -> dict:
    """Each model's random decode state (drawn in f32, rounded to the
    leaf's type by each side) and decode tokens; the boundary case's
    operands."""
    data = {"decode_tokens": np.random.default_rng(3).integers(
        0, 256, (B, DECODE_STEPS)).astype(np.int32)}
    for arch in ARCHS:
        rng = np.random.default_rng(2)
        for k, (shape, _) in sorted(state_leaves(config(arch)).items()):
            data[f"{arch}/state/{k}"] = rng.normal(size=shape).astype(
                np.float32)
    b, s, h, kv, hd = (BOUNDARY[k] for k in ("b", "s", "h", "kv", "hd"))
    rng = np.random.default_rng(4)
    data["boundary/q"] = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    for k in "kv":
        data[f"boundary/{k}"] = rng.normal(size=(b, s, kv, hd)).astype(
            np.float32)
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
from repro.launch.variants import apply_variant
from repro.models import transformer as jt
from repro.models.config import ShapeSpec
from repro.serve.serve_step import decode_state_shardings, make_serve_step
from repro.sharding import DEFAULT_RULES, logical_sharding, shardings_for

where = sys.argv[1]
spec = json.loads(os.environ["MULTIRANK_SPEC"])
assert jax.device_count() == 4, jax.devices()
data = dict(np.load(os.path.join(where, "data.npz")))
out = {}


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flat(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [kv for k, t in zip("kv", tree)
                for kv in flat(t, f"{prefix}{k}/")]
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
    for variant in spec["variants"]:
        rules = apply_variant(DEFAULT_RULES, arch, "decode", variant)
        for name, shape in spec["meshes"].items():
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            tag = f"{arch}/{variant}/{name}"
            jp = jax.device_put(params, shardings_for(jt.build_specs(cfg),
                                                      mesh, rules))
            state = {"pos": jnp.asarray(spec["pos0"], jnp.int32)}
            for k, dtype in spec["state"][arch].items():
                leaf = jnp.asarray(data[f"{arch}/state/{k}"],
                                   getattr(jnp, dtype))
                if k.startswith("img_kv/"):
                    state.setdefault("img_kv", {})[k[-1]] = leaf
                else:
                    state[k] = leaf
            if "img_kv" in state:
                state["img_kv"] = (state["img_kv"]["k"], state["img_kv"]["v"])
            sh = decode_state_shardings(
                cfg, ShapeSpec("state", spec["max_seq"], spec["b"],
                               "decode"), mesh, rules)
            state = jax.device_put(state, {k: sh[k] for k in state})
            for k, v in flat(state):
                shards(f"{tag}/init", k, v, mesh)
            step = jax.jit(make_serve_step(cfg, mesh, rules))
            logits = []
            for i in range(spec["decode_steps"]):
                toks = jax.device_put(
                    data["decode_tokens"][:, i:i + 1], logical_sharding(
                        ("batch", "seq"), (spec["b"], 1), mesh, rules))
                lg, state = step(jp, state, toks)
                logits.append(host(lg))
                for k, v in flat(state):
                    shards(f"{tag}/step{i}", k, v, mesh)
            out[f"{tag}/decode"] = np.stack(logits)
np.savez(os.path.join(where, "jax.npz"), **out)
print("JAX_DONE")
"""


def _spec() -> dict:
    state = {arch: {k: str(dtype).rsplit(".", 1)[1]
                    for k, (_, dtype) in state_leaves(config(arch)).items()}
             for arch in ARCHS}
    return {"archs": ARCHS, "variants": VARIANTS, "meshes": MESHES,
            "pos0": POS0, "b": B, "max_seq": MAX_SEQ, "state": state,
            "decode_steps": DECODE_STEPS, "gate_seed": GATE_SEED}


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


def _state(cfg, arch, data) -> dict:
    state = {"pos": POS0}
    img = {}
    for k, (_, dtype) in state_leaves(cfg).items():
        t = torch.from_numpy(data[f"{arch}/state/{k}"]).to(dtype)
        if k.startswith("img_kv/"):
            img[k[-1]] = t
        else:
            state[k] = t
    if img:
        state["img_kv"] = (img["k"], img["v"])
    return state


def _leaves(state) -> dict:
    """A state's tensor leaves by ``state_leaves``' names."""
    out = {}
    for k, v in state.items():
        if k == "img_kv":
            out.update({f"img_kv/{n}": t for n, t in zip("kv", v)})
        elif k != "pos":
            out[k] = v
    return out


def _load_params(where, arch):
    path = os.path.join(where, f"{arch}.npz")
    while not os.path.exists(path):
        time.sleep(0.05)                 # the JAX side writes the init
    return params_from_jax(nested(dict(np.load(path)), ""), "cpu")


def _boundary_case(mesh, data) -> dict:
    """``seq_on_shards`` alone on the mesh: q (batch on "data", heads on
    "model") over a cache split along its sequence on "model" whose
    positions at or past ``kv_len`` hold 1e4; the output, its placements
    and the local operand shapes."""
    import functools
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels._local import seq_on_shards, shard_calls
    from repro_torch.kernels.flash_attention.ref import decode_attention_block
    n = BOUNDARY["kv_len"]
    q = distribute_tensor(torch.from_numpy(data["boundary/q"]), mesh,
                          (Shard(0), Shard(2)))
    kv = []
    for k in "kv":
        t = torch.from_numpy(data[f"boundary/{k}"]).clone()
        t[:, n:] = 1e4
        kv.append(distribute_tensor(t, mesh, (Shard(0), Shard(1))))
    with shard_calls() as calls:
        out = seq_on_shards("decode_attention", functools.partial(
            decode_attention_block), q, *kv, n)
    return {"out": _np(out.full_tensor()), "calls": calls,
            "placements": tuple(map(repr, out.placements))}


def twin(cfg, mesh, rules, pos=None):
    """The dry-run twin of a decode step at (B, ``MAX_SEQ``) on ``mesh``
    under ``rules``, f32 params, counted (``Lowered.count``).  ``pos``:
    the position it writes, where not the lowered step's last one (a rank
    writes only the positions its block of the cache holds, so its own
    work depends on the position; what it dispatches does not); past the
    first step (``POS0``) a conv state in f32, as the first step under f32
    params leaves it."""
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.models.config import ShapeSpec
    low = lower_step(cfg, ShapeSpec("twin_decode", MAX_SEQ, B, "decode"),
                     mesh, rules)
    if pos is not None:
        def build(m, trace):
            step = make_serve_step(cfg, m, rules, trace=trace)
            return lambda params, state, x: step(
                params, dict(state, pos=pos), x)
        low.build = build
        params, state, x = low.args
        if pos > POS0 and "conv" in state:
            low.args = (params, dict(state, conv=state["conv"].float()), x)
    return low.count(torch.float32)


def _run(arch, variant, where, data, params, out) -> None:
    """One model's decode under one variant on both meshes."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.kernels._local import shard_calls
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models.transformer import build_specs
    from repro_torch.serve.serve_step import distribute_state
    from repro_torch.roofline.trace import RankTally
    from repro_torch.sharding import (DEFAULT_RULES, distribute_inputs,
                                      distribute_tree, shardings_for)
    cfg = config(arch)
    rules = apply_variant(DEFAULT_RULES, arch, "decode", variant)
    for name, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        r = out[name] = {"coord": tuple(mesh.get_coordinate()), "steps": []}
        dp = distribute_tree(params, shardings_for(build_specs(cfg), mesh,
                                                   rules))
        step = make_serve_step(cfg, mesh, rules)
        placed = distribute_state(cfg, _state(cfg, arch, data), mesh, rules)
        r["init"] = {k: _np(v.to_local()) for k, v in _leaves(placed).items()}
        tokens = [torch.from_numpy(data["decode_tokens"][:, i:i + 1])
                  for i in range(DECODE_STEPS)]
        # as a caller decodes: the global state and tokens, which the step
        # places, and each step's returned state fed to the next
        state, logits = _state(cfg, arch, data), []
        with shard_calls() as calls:
            for x in tokens:
                lg, state = step(dp, state, x)
                logits.append(_np(lg.full_tensor()))
                r["steps"].append({k: _np(v.to_local())
                                   for k, v in _leaves(state).items()})
        r["decode"], r["calls"] = np.stack(logits), calls
        last = state
        # the same steps tallied, on a state of their own, their inputs in
        # the twin's form: placed before the step, the position an int
        state, logits, measured, cost = placed, [], [], []
        for i, x in enumerate(tokens):
            x = distribute_inputs({"tokens": x}, mesh, rules)["tokens"]
            with RankTally() as tally:
                lg, state = step(dp, dict(state, pos=POS0 + i), x)
            measured.append(tally.by_kind())
            cost.append((tally.flops, tally.bytes))
            logits.append(_np(lg.full_tensor()))
        r["decode_tallied"] = np.stack(logits)
        c = twin(cfg, mesh, rules).collectives
        r["comm"] = (measured, (c.counts, c.bytes_by_kind))
        r["cost"] = [(got, (t.flops, t.bytes)) for got, t in zip(cost, (
            twin(cfg, mesh, rules, POS0 + i) for i in range(DECODE_STEPS)))]
        cache = last["k"] if "k" in last else last["shared_k"]
        size, offset = compute_local_shape_and_global_offset(
            cache.shape, mesh, cache.placements)
        r["seq_block"] = (offset[2], size[2])
        r["cache_placements"] = tuple(map(repr, cache.placements))
        if arch == "qwen3-1.7b" and variant == VARIANTS[0]:
            r["boundary"] = _boundary_case(mesh, data)


def rank_work(rank: int, where: str) -> dict:
    """One rank's share of every check (``runs`` reads the results)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    data = dict(np.load(os.path.join(where, "data.npz")))
    out = {"backend": dist.get_backend()}
    for arch in ARCHS:
        params = _load_params(where, arch)
        for variant in VARIANTS:
            _run(arch, variant, where, data, params,
                 out.setdefault(f"{arch}/{variant}", {}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's decode and the four ranks (started together, under the
    multi-rank lock), and the port's unmeshed decode on the same weights
    and state."""
    from repro_torch.launch.ranks import run_ranks
    where = tmp_path_factory.mktemp("multirank_cache_seq")
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
    plain = {}
    for arch in ARCHS:
        cfg, params = config(arch), _load_params(where, arch)
        step = make_serve_step(cfg, "cpu")
        state, logits = _state(cfg, arch, data), []
        for i in range(DECODE_STEPS):
            lg, state = step(params, state, torch.from_numpy(
                data["decode_tokens"][:, i:i + 1]))
            logits.append(_np(lg))
        plain[arch] = np.stack(logits)
    return {"ranks": ranks, "jax": jx, "plain": plain, "data": data}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

CASES = [(a, v, m) for a in ARCHS for v in VARIANTS for m in sorted(MESHES)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each value (its f32 ulp times 2 ** 16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 65536


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_state_shards_match_jax_after_every_step(runs, arch, variant, mesh):
    """Each rank's local shard of every state leaf (the sequence-split k /
    v or shared k / v, the conv and SSD states, the image K/V) against
    JAX's addressable shard at the rank's (data, model) coordinate: the
    random state as placed, bit for bit; after every step, in a KV cache
    every element the step did not write (JAX's unchanged) keeps the
    rank's own earlier bits, and the new k / v within one bf16 ulp of
    JAX's (each side rounds its own f32 product to bf16, and a value
    within an f32 ulp of a tie rounds either way: one element of the
    1,280 that a case writes, at most), the image K/V bit for bit, and the
    conv and SSD states that each step rewrites (f32) at 1e-4."""
    jx = runs["jax"]
    names = set(state_leaves(config(arch)))
    coords, flipped = set(), 0
    tag = f"{arch}/{variant}/{mesh}"
    for r in runs["ranks"]:
        assert r["backend"] == "gloo"
        got = r[f"{arch}/{variant}"][mesh]
        coords.add(got["coord"])
        i, j = got["coord"]
        assert set(got["init"]) == names
        for key, local in got["init"].items():
            want = jx[f"{tag}/init/shard/{key}/{i}{j}"]
            assert local.shape == want.shape and np.array_equal(local, want)
        assert len(got["steps"]) == DECODE_STEPS
        prev = got["init"]
        for s, leaves in enumerate(got["steps"]):
            assert set(leaves) == names
            for key, local in leaves.items():
                want = jx[f"{tag}/step{s}/shard/{key}/{i}{j}"]
                before = jx[f"{tag}/{f'step{s - 1}' if s else 'init'}"
                            f"/shard/{key}/{i}{j}"]
                assert local.shape == want.shape, (s, key, local.shape,
                                                   want.shape)
                if key in ("conv", "ssd"):
                    _close(local, want, TOL, f"step {s} {key}")
                    continue
                kept = want == before
                assert np.array_equal(local[kept], prev[key][kept]), (s, key)
                new, ref = local[~kept], want[~kept]
                assert (np.abs(new - ref) <= _bf16_ulp(ref)).all(), (s, key)
                flipped += int((new != ref).sum())
            prev = leaves
    assert len(coords) == WORLD
    assert flipped <= 1, flipped


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_decode_matches_jax_and_unmeshed(runs, arch, variant, mesh):
    """Each step's logits at 1e-4 against JAX's decode under the same
    rules and the port's unmeshed decode; every rank gathers the same
    logits."""
    first = runs["ranks"][0][f"{arch}/{variant}"][mesh]
    for r in runs["ranks"]:
        assert np.array_equal(r[f"{arch}/{variant}"][mesh]["decode"],
                              first["decode"])
    assert first["decode"].shape == (DECODE_STEPS, B, 1, 256)
    _close(first["decode"], runs["jax"][f"{arch}/{variant}/{mesh}/decode"],
           TOL, "decode vs JAX")
    _close(first["decode"], runs["plain"][arch], TOL, "decode vs unmeshed")


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_positions_land_on_several_ranks(runs, arch, variant, mesh):
    """From each rank's local cache: the sequence is split over "model"
    (blocks of 8 / model positions), the steps' writes (the positions
    whose values changed from the random state) landed on at least two
    "model" ranks, each inside its own block, and at the first step
    (``kv_len`` 2) every rank but the first "model" rank held no valid
    position."""
    data = runs["data"]
    _, model = MESHES[mesh]
    key = "k" if "k" in state_leaves(config(arch)) else "shared_k"
    writers, kv_len = set(), POS0 + 1
    for r in runs["ranks"]:
        got = r[f"{arch}/{variant}"][mesh]
        lo, n = got["seq_block"]
        assert n == MAX_SEQ // model
        assert got["cache_placements"][1] == "Shard(dim=2)"
        i, j = got["coord"]
        assert lo == j * n
        start = torch.from_numpy(data[f"{arch}/state/{key}"]).bfloat16()
        b0 = i * (B // MESHES[mesh][0])
        before = start[:, b0:b0 + B // MESHES[mesh][0], lo:lo + n].float()
        after = torch.from_numpy(got["steps"][-1][key])
        changed = (before != after).flatten(3).any(-1).any(1).any(0)
        pos = [lo + p for p in range(n) if bool(changed[p])]
        assert all(POS0 <= p < POS0 + DECODE_STEPS for p in pos), pos
        if pos:
            writers.add(j)
        assert (lo < kv_len) == (j == 0)
    assert len(writers) >= 2, writers


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_twin_counts_the_collectives_each_rank_dispatches(runs, arch,
                                                          variant, mesh):
    """Every decode step's collectives on each rank, in calls and bytes by
    kind, equal the dry-run twin's count of the step lowered on that
    rank's mesh under the variant's rules (it writes another position:
    what a step dispatches does not depend on it), the split-sequence
    boundary's all-reduce of the rows' maxima included."""
    for r in runs["ranks"]:
        got = r[f"{arch}/{variant}"][mesh]
        measured, counted = got["comm"]
        assert len(measured) == DECODE_STEPS
        for step in measured:
            assert step == counted, got["coord"]
        assert counted[0].get("all-reduce", 0) > 0


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_tallied_steps_decode_as_the_callers_steps(runs, arch, variant,
                                                   mesh):
    """The steps tallied for the twin (inputs placed before each step, the
    position an int) give the logits of the steps a caller runs (global
    inputs the step places, its returned state fed back), on each rank."""
    for r in runs["ranks"]:
        got = r[f"{arch}/{variant}"][mesh]
        assert np.array_equal(got["decode_tallied"], got["decode"]), \
            got["coord"]


@pytest.mark.parametrize("arch,variant,mesh", CASES)
def test_twin_counts_the_flops_and_bytes_each_rank_runs(runs, arch,
                                                        variant, mesh):
    """Every decode step's FLOPs and bytes accessed on each rank, by the
    tally that counts the twin, equal the twin's count of the step at its
    position."""
    for r in runs["ranks"]:
        got = r[f"{arch}/{variant}"][mesh]
        assert len(got["cost"]) == DECODE_STEPS
        for i, (measured, counted) in enumerate(got["cost"]):
            assert measured == counted, (got["coord"], i)
            assert counted[0] > 0 and counted[1] > 0


def test_split_sequence_boundary_alone(runs):
    """``seq_on_shards`` on the 2x2 mesh (q's batch on "data" and heads on
    "model", the cache's sequence on "model"; ``kv_len`` 2 leaves the
    second "model" rank no valid position, and every invalid position
    holds 1e4): the output equals ``decode_attention_ref`` on the clean
    cache at 1e-6, placed as q was; each rank's step saw its 2 sequences,
    all 4 q heads and its 4 positions; on 1x4, its 2."""
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    data = runs["data"]
    q, k, v = (torch.from_numpy(data[f"boundary/{n}"]) for n in "qkv")
    want = _np(decode_attention_ref(q, k, v, BOUNDARY["kv_len"]))
    b, s, h, kv, hd = (BOUNDARY[n] for n in ("b", "s", "h", "kv", "hd"))
    for r in runs["ranks"]:
        for mesh, (dm, mm) in MESHES.items():
            got = r[f"qwen3-1.7b/{VARIANTS[0]}"][mesh]["boundary"]
            _close(got["out"], want, 1e-6, f"boundary {mesh}")
            assert got["placements"] == ("Shard(dim=0)", "Shard(dim=2)")
            assert got["calls"] == [("decode_attention", (
                (b // dm, 1, h, hd), (b // dm, s // mm, kv, hd),
                (b // dm, s // mm, kv, hd)))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_decode_attention_ran_on_own_positions(runs, mesh):
    """In every model's decode under both variants, decode attention's
    local operands were each rank's batch rows, q with every head (gathered
    on "model") and the cache's own 8 / model positions with every KV
    head: the cache was never gathered."""
    data, model = MESHES[mesh]
    for arch in ARCHS:
        cfg = config(arch)
        q = (B // data, 1, cfg.n_heads, cfg.hd)
        kv = (B // data, MAX_SEQ // model, cfg.n_kv_heads, cfg.hd)
        fired = -(-cfg.n_layers // cfg.shared_attn_every) \
            if cfg.family == "hybrid" else cfg.n_layers
        for variant in VARIANTS:
            for r in runs["ranks"]:
                calls = [s for n, s in r[f"{arch}/{variant}"][mesh]["calls"]
                         if n == "decode_attention"]
                assert calls == [(q, kv, kv)] * (DECODE_STEPS * fired), \
                    (arch, variant, calls[:2])
