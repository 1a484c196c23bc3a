"""The port's dry-run (``repro_torch.launch.dryrun``) and the lowered steps
it traces (``lower_train_step``, ``lower_prefill``, ``lower_serve_step``,
``roofline.trace``), on the CPU at small sizes.

* Argument bytes: on 1 x 1 meshes, for the reduced config of each of the
  six families under train, prefill and decode (B 2 x S 256), the traced
  step's ``argument_size_in_bytes`` equals the reference's
  ``lower_*(...).compile().memory_analysis()`` exactly (909,060 / 1,262,180
  / 1,405,060 bytes for qwen3 / zamba2 / granite train), and so does its
  ``alias_size_in_bytes``; its ``output_size_in_bytes`` is XLA's less the
  8 bytes a leaf XLA adds for a tuple result's table of buffers.
* FLOPs: the reference's ``cost_analysis()["flops"]`` (``unroll =
  n_layers``, so XLA counts every layer) over the traced count sits in a
  band measured per family and kind (``FLOP_BANDS``); on the reduced dense
  cell the prefill's and the decode step's counts equal an independent
  count of their products exactly.
* Depth: the full-depth count equals the reference's two-depth linear
  extrapolation (``repro.launch.dryrun.run_cell``).
* Production meshes: ``run_cell`` gives ``ok`` rows with the reference's
  keys on both (reduced configs, small shapes; ``trace_s`` the time of the
  mesh's two rank runs, ``count_s`` the wall time of both depths' counts),
  per-device argument bytes the sum of the leaves' ``shard_shape`` bytes;
  a real ``DeviceMesh`` on torch's fake process group (in a subprocess)
  gives the stand-in's numbers.
* CLI: ``--out`` resumes, skipping done cells unless ``--force``.
* Refusal: a traced step takes ``meta`` tensors only; executing on a mesh
  of more than one device still raises.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.roofline.analysis import Roofline as RefRoofline

from repro_torch.configs import CONFIGS, SHAPES, reduced_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import (build_specs, init_decode_state,
                                            init_params)
from repro_torch.roofline.trace import _flatten
from repro_torch.serve.serve_step import (lower_prefill, lower_serve_step,
                                          make_prefill, make_serve_step)
from repro_torch.sharding import DEFAULT_RULES, shardings_for
from repro_torch.sharding.rules import logical_sharding
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.train_step import (batch_shardings, batch_structs,
                                          lower_train_step, make_train_step)

from conftest import requires_mesh_axis_types

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {"dense": "qwen3-1.7b", "hybrid": "zamba2-1.2b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-370m",
            "audio": "musicgen-large", "vlm": "llama-3.2-vision-90b"}
KINDS = ("train", "prefill", "decode")
B, S = 2, 256
# XLA's FLOPs over the traced count, (low, high), measured on these cells:
# XLA also counts elementwise work, which the SSD's many small products and
# a decode step's short rows make large beside the products
FLOP_BANDS = {
    ("dense", "train"): (1.05, 1.09), ("dense", "prefill"): (1.05, 1.09),
    ("dense", "decode"): (2.29, 2.40),
    ("hybrid", "train"): (1.92, 2.00), ("hybrid", "prefill"): (1.55, 1.63),
    ("hybrid", "decode"): (2.50, 2.61),
    ("moe", "train"): (1.05, 1.09), ("moe", "prefill"): (1.06, 1.11),
    ("moe", "decode"): (2.23, 2.34),
    ("ssm", "train"): (1.84, 1.92), ("ssm", "prefill"): (1.13, 1.19),
    ("ssm", "decode"): (2.21, 2.31),
    ("audio", "train"): (1.03, 1.08), ("audio", "prefill"): (1.04, 1.09),
    ("audio", "decode"): (2.26, 2.36),
    ("vlm", "train"): (1.10, 1.15), ("vlm", "prefill"): (1.11, 1.16),
    ("vlm", "decode"): (2.30, 2.41),
}
CELLS = [(f, k) for f in FAMILIES for k in KINDS]
LOWER = {"train": lower_train_step, "prefill": lower_prefill,
         "decode": lower_serve_step}
_REF: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Torch on two threads: the test workers share the machine's cores, and
    torch's default (one thread per core) in every worker slows the others,
    wall-clock assertions included; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def reference(family: str, kind: str) -> dict:
    """The reference's compiled step of the cell on its 1 x 1 mesh (every
    layer unrolled): memory analysis and FLOPs, once a process."""
    if (family, kind) not in _REF:
        from repro.launch.mesh import make_local_mesh
        from repro.serve.serve_step import (lower_prefill as ref_prefill,
                                            lower_serve_step as ref_serve)
        from repro.train.train_step import lower_train_step as ref_train
        cfg = ref_reduced_config(FAMILIES[family])
        low = {"train": ref_train, "prefill": ref_prefill,
               "decode": ref_serve}[kind]
        mesh = make_local_mesh()
        with mesh:
            c = low(cfg, RefShapeSpec("cell", S, B, kind), mesh,
                    DEFAULT_RULES, unroll=cfg.n_layers).compile()
        m = c.memory_analysis()
        _REF[family, kind] = {
            "argument": m.argument_size_in_bytes,
            "output": m.output_size_in_bytes,
            "alias": m.alias_size_in_bytes,
            "flops": float(c.cost_analysis()["flops"])}
    return _REF[family, kind]


def traced(family: str, kind: str, mesh=None, **cfg_kw):
    cfg = dataclasses.replace(reduced_config(FAMILIES[family]), **cfg_kw)
    return LOWER[kind](cfg, ShapeSpec("cell", S, B, kind),
                       mesh or abstract_mesh(local=True),
                       DEFAULT_RULES).compile()


@requires_mesh_axis_types
@pytest.mark.parametrize("family,kind", CELLS)
def test_argument_output_and_alias_bytes_equal_the_reference(family, kind):
    got = traced(family, kind)
    mem = got.memory_analysis()
    want = reference(family, kind)
    assert mem.argument_size_in_bytes == want["argument"]
    assert mem.alias_size_in_bytes == want["alias"]
    leaves = sum(1 for _ in _flatten(got.trace.outputs))
    table = 8 * leaves if leaves > 1 else 0
    assert mem.output_size_in_bytes + table == want["output"]
    if (family, kind) == ("dense", "train"):
        assert mem.argument_size_in_bytes == 909_060


@requires_mesh_axis_types
@pytest.mark.parametrize("family,kind", CELLS)
def test_flops_sit_in_the_family_band_of_the_reference(family, kind):
    got = traced(family, kind).cost_analysis()["flops"]
    lo, hi = FLOP_BANDS[family, kind]
    assert lo <= reference(family, kind)["flops"] / got <= hi


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dense_flops_equal_an_independent_count_of_the_products(kind):
    """Reduced qwen3-1.7b: per layer the q, k, v, o and SwiGLU weights, and
    attention's two products over every key (the plain flash version
    computes the masked block too; decode reads the whole cache), then the
    tied head; 2 FLOPs a multiply-add."""
    cfg = reduced_config("qwen3-1.7b")
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    weights = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff
    rows, q = (B * S, S) if kind == "prefill" else (B, 1)
    attention = 2 * 2 * B * H * q * S * hd
    want = (cfg.n_layers * (2 * rows * weights + attention)
            + 2 * rows * d * cfg.vocab)
    assert traced("dense", kind).cost_analysis()["flops"] == want


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_full_depth_equals_the_two_depth_extrapolation(family):
    """The reference compiles depths p and 2p (p: the cross / shared block
    period) and extrapolates linearly to L; the port traces L itself."""
    cfg = reduced_config(FAMILIES[family])
    p = max(1, cfg.cross_attn_every or 0, cfg.shared_attn_every or 0)
    L = 3 * p
    c1, c2, full = (traced(family, "train", n_layers=n).cost_analysis()
                    ["flops"] for n in (p, 2 * p, L))
    assert c1 < c2 < full
    assert full == c1 + (c2 - c1) * (L - p) / p


SMALL_SHAPES = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
                "prefill_32k": ShapeSpec("prefill_32k", 64, 32, "prefill"),
                "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode"),
                "long_500k": ShapeSpec("long_500k", 256, 1, "decode")}


@pytest.fixture
def small_dryrun(monkeypatch):
    """``launch.dryrun`` over reduced configs and small shapes."""
    monkeypatch.setattr(dryrun, "get_config", reduced_config)
    monkeypatch.setattr(dryrun, "SHAPES", SMALL_SHAPES)
    return dryrun


def _arg_bytes(cfg, shape, mesh, rules):
    """Per-device argument bytes from each leaf's ``shard_shape``."""
    def block(shp, sh, itemsize):
        n = 1
        for x in sh.shard_shape(shp):
            n *= x
        return n * itemsize
    if shape.kind != "train":
        raise ValueError(shape.kind)
    specs = build_specs(cfg)
    total = 4                                              # AdamW's step
    for (s, _), (sh, _) in zip(_flatten(specs), _flatten(
            shardings_for(specs, mesh, rules))):
        total += block(s.shape, sh, s.dtype.itemsize) + 2 * block(
            s.shape, sh, 4)
    structs = batch_structs(cfg, shape)
    for k, sh in batch_shardings(cfg, shape, mesh, rules).items():
        total += block(structs[k].shape, sh, structs[k].element_size())
    return total


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
def test_run_cell_on_both_production_meshes(arch, small_dryrun):
    ref_keys = set(RefRoofline("a", "s", "m", 1, 0, 0, 0, 0, 0, 0, 0).row())
    keys = (ref_keys - {"fits_hbm_16g"}) | {
        "fits_hbm_80g", "status", "variant", "remat", "compile_s", "memory",
        "kind", "params_b", "active_params_b", "trace_s", "count_s"}
    cfg = reduced_config(arch)
    for shape in SMALL_SHAPES:
        rows = {m: small_dryrun.run_cell(arch, shape, m)
                for m in ("single", "multi")}
        if shape in cfg.skip_shapes:
            assert {r["status"] for r in rows.values()} == {"skipped"}
            continue
        for mesh, row in rows.items():
            assert row["status"] == "ok", row.get("trace")
            assert set(row) == keys
            assert row["chips"] == (256 if mesh == "single" else 512)
            assert row["collectives"].get("all-gather", 0) > 0
        # each mesh counts its own rank's runs, inside the cell's count
        for row in rows.values():
            assert 0 <= row["trace_s"] <= row["count_s"] <= row["compile_s"]
        if shape == "train_4k":
            for mesh, row in rows.items():
                rules = small_dryrun.rules_for(arch, shape)
                want = _arg_bytes(cfg, SMALL_SHAPES[shape],
                                  small_dryrun.mesh_for(mesh), rules)
                assert row["memory"]["argument_size_in_bytes"] == want


@pytest.mark.parametrize("loss_impl", ["dense", "chunked"])
def test_rank_step_keeps_the_vocab_split(small_dryrun, loss_impl):
    """Reduced qwen3-1.7b's train step on the 16 x 16 mesh (vocab 256 over
    16 "model" ranks, B 32 over 16 "data" ranks), counted on one rank:
    under the dense loss and the chunked one, no allocation has the
    global (B, S, V) shape or the vocab-whole (B / 16, S, V) shape, and
    none of the run's largest is a logits block wider than the rank's."""
    cfg = reduced_config("qwen3-1.7b")
    shape = SMALL_SHAPES["train_4k"]
    B, S, V = shape.global_batch, shape.seq_len, cfg.vocab
    c = small_dryrun.compile_step(
        cfg, shape, small_dryrun.mesh_for("single"),
        small_dryrun.rules_for("qwen3-1.7b", "train_4k"), "full", loss_impl)
    assert not {(B, S, V), (B // 16, S, V)} & c.trace.shapes
    assert (B // 16, S, V // 16) in c.trace.shapes
    assert c.trace.largest and all(
        shape[-1] != V for _, _, shape in c.trace.largest)


def test_rank_runs_its_share_of_experts_model_cannot_split(small_dryrun):
    """granite with 40 experts (reduced widths, d_ff 64) on the 16 x 16
    mesh: 16 "model" ranks do not divide the experts, so the rules split
    their ffn width there, as the reference's do, and one rank's counted
    train step runs every MoE layer's experts on (40, d, 64 / 16)
    weights (the FSDP axis gathered) over the whole dispatch buffer."""
    from repro_torch.kernels._local import shard_calls
    from repro_torch.models.moe import capacity
    cfg = dataclasses.replace(reduced_config("granite-moe-3b-a800m"),
                              n_experts=40)
    shape = SMALL_SHAPES["train_4k"]
    d, f, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    T = shape.global_batch * shape.seq_len
    C = capacity(cfg, T)
    with shard_calls() as calls:
        small_dryrun.compile_step(
            cfg, shape, small_dryrun.mesh_for("single"),
            small_dryrun.rules_for("granite-moe-3b-a800m", "train_4k"),
            "full")
    experts = [shapes for name, shapes in calls if name == "moe_experts"]
    buffers = [shapes for name, shapes in calls if name == "moe_buffer"]
    # each layer's forward and its recompute
    assert len(experts) == len(buffers) == 2 * cfg.n_layers
    assert set(experts) == {((T, d), (T, k), (T, k), (E, d, f // 16),
                             (E, d, f // 16), (E, f // 16, d))}
    assert set(buffers) == {((E, C, d),)}


def test_cli_resumes_and_force_recomputes(small_dryrun, tmp_path, capsys):
    out = tmp_path / "dryrun_results.json"
    argv = ["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--mesh",
            "both", "--out", str(out)]
    assert small_dryrun.main(argv) == 0
    first = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in first] == [
        ("single", "ok"), ("multi", "ok")]
    capsys.readouterr()
    assert small_dryrun.main(argv) == 0
    assert "[dryrun] qwen3-1.7b" not in capsys.readouterr().out
    assert json.loads(out.read_text()) == first
    assert small_dryrun.main(argv + ["--force"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("[dryrun] qwen3-1.7b × decode_32k") == 2
    assert len(json.loads(out.read_text())) == 2
    assert small_dryrun.main(["--arch", "qwen3-1.7b", "--shape",
                              "long_500k", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert rows[-1]["status"] == "skipped" and len(rows) == 3


def test_cli_explains_a_cell(small_dryrun, tmp_path, capsys):
    """``--explain`` prints each cell's rank step in words beside its row:
    the ops that lead its FLOPs and bytes, what is live at its temp peak,
    its largest allocations, its collectives, and its kernel boundary
    calls' local shapes (the loss on the rank's (B / 16, S, V / 16)
    logits block, once: reduced qwen3-1.7b is counted at its depth)."""
    out = tmp_path / "dryrun_results.json"
    assert small_dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                              "--explain", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "train step on 256 device(s), one rank's step" in printed
    for part in ("FLOPs by op:", "bytes by op (calls):",
                 "largest allocations live at the temp peak:",
                 "largest allocations of the run:",
                 "kernel boundary calls (local operand shapes; calls):",
                 "  lm_loss [[2, 64, 16], [2, 64]]: 1",
                 "collectives per device:", "  all-gather: "):
        assert part in printed, part
    assert json.loads(out.read_text())[0]["status"] == "ok"


def _cpu_inputs(build, cfg):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    if build == "train":
        return (params, init_state(params),
                {"tokens": tokens, "labels": tokens})
    if build == "prefill":
        return (params,), {"tokens": tokens}
    return (params, init_decode_state(cfg, 2, 8, device="cpu"),
            tokens[:, :1])


@pytest.mark.parametrize("build", ["train", "prefill", "serve"])
def test_traced_steps_refuse_to_execute(build):
    """A step built with ``trace=True`` on a 16 x 16 mesh runs on ``meta``
    tensors; given CPU tensors it raises (a traced step executes nothing),
    and the builders without ``trace`` refuse the abstract mesh (it has no
    ranks to execute on)."""
    cfg = reduced_config("qwen3-1.7b")
    mesh = abstract_mesh()
    make = {"train": lambda **kw: make_train_step(cfg, AdamWConfig(), mesh,
                                                  DEFAULT_RULES, **kw),
            "prefill": lambda **kw: make_prefill(cfg, mesh, DEFAULT_RULES,
                                                 **kw),
            "serve": lambda **kw: make_serve_step(cfg, mesh, DEFAULT_RULES,
                                                  **kw)}[build]
    with pytest.raises(NotImplementedError, match="without ranks"):
        make()
    step = make(trace=True)
    inputs = _cpu_inputs(build, cfg)
    with pytest.raises(NotImplementedError, match="meta tensors"):
        if build == "prefill":
            step(*inputs[0], **inputs[1])
        else:
            step(*inputs)
    shape = ShapeSpec("cell", 8, 2, {"serve": "decode"}.get(build, build))
    low = {"train": lower_train_step, "prefill": lower_prefill,
           "serve": lower_serve_step}[build](cfg, shape, mesh, DEFAULT_RULES)
    assert low.compile().cost_analysis()["flops"] > 0


_DEVICE_MESH = r"""
import json, sys
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import abstract_mesh, make_production_mesh
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
from repro_torch.train.train_step import lower_train_step
cfg = reduced_config("granite-moe-3b-a800m")
shape = ShapeSpec("cell", 64, 32, "train")
out = {}
for name, mesh in (("device_mesh", make_production_mesh()),
                   ("abstract", abstract_mesh())):
    c = lower_train_step(cfg, shape, mesh, DEFAULT_RULES).compile()
    m = c.memory_analysis()
    coll = c.collectives()
    out[name] = {"memory": [m.argument_size_in_bytes, m.output_size_in_bytes,
                            m.alias_size_in_bytes, m.temp_size_in_bytes],
                 "cost": c.cost_analysis(), "counts": coll.counts,
                 "bytes": coll.bytes_by_kind, "type": type(mesh).__name__}
print(json.dumps(out))
"""


def test_a_device_mesh_on_the_fake_group_gives_the_stand_ins_numbers():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _DEVICE_MESH],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    dm, ab = out["device_mesh"], out["abstract"]
    assert dm.pop("type") == "DeviceMesh" and ab.pop("type") == "AbstractMesh"
    assert dm == ab
    assert ab["counts"]["all-reduce"] > 0 and ab["counts"]["all-gather"] > 0


@pytest.mark.parametrize("name", ["lower_train_step", "lower_prefill",
                                  "lower_serve_step"])
def test_lowering_entry_points_take_the_references_signature(name):
    import inspect
    from repro.serve import serve_step as ref_serve
    from repro.train import train_step as ref_train
    from repro_torch.serve import serve_step
    from repro_torch.train import train_step
    ref = getattr(ref_train if name == "lower_train_step" else ref_serve,
                  name)
    port = getattr(train_step if name == "lower_train_step" else serve_step,
                   name)
    sig = {k: (p.kind, p.default)
           for k, p in inspect.signature(port).parameters.items()}
    ref_sig = {k: (p.kind, p.default)
               for k, p in inspect.signature(ref).parameters.items()}
    assert sig == ref_sig
