"""The dry-run's per-device numbers (``launch.dryrun``): one rank's step
counted on ``meta`` DTensors (``Lowered.count``) at depths 2p and 3p (p =
max(1, ``cross_attn_every``, ``shared_attn_every``)) and extrapolated, as
the reference's ``run_cell`` extrapolates XLA's counts, against the count
of the step at full depth.

The reduced config of each of the six families, cut to 6p layers, under
train, prefill and decode (B 32 x S 64), on a (2, 2) mesh and on the
(16, 16) production mesh, both abstract (``launch.mesh.abstract_mesh``)
and so counted as rank 0 of torch's fake process group
(``launch.mesh.rank_mesh``):

* the two-depth extrapolation equals the full-depth count exactly: the
  collectives in calls and bytes by kind (and the step gathers
  something), and the FLOPs, bytes accessed, temp peak and argument,
  output and alias bytes of ``compile_step`` against the full-depth
  step's ``compile()``, with the serving steps' temp as flat from 2p to
  3p as at 6p; a train step's temp extrapolation, where its peak moves
  past 3p, a lower bound (one cell);
* the depth-2p step counted a second time in the same process gives the
  same numbers: DTensor's sharding propagation, which runs ops only when
  its cache misses, is not counted;
* on the 2 x 2 mesh a rank of the dense and vlm families runs exactly a
  quarter of the global trace's FLOPs; an MoE rank runs more (the route
  on the whole batch on every rank);
* on a 1 x 1 mesh ``compile_step`` gives the global trace's numbers.

The counts run in a subprocess (a default process group is process-wide),
once for the module.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {"dense": "qwen3-1.7b", "hybrid": "zamba2-1.2b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-370m",
            "audio": "musicgen-large", "vlm": "llama-3.2-vision-90b"}
KINDS = ("train", "prefill", "decode")
MESHES = {"2x2": (2, 2), "16x16": (16, 16)}
B, S = 32, 64
CASES = [(f, k, m) for f in FAMILIES for k in KINDS for m in MESHES]
CELLS = [(f, k) for f in FAMILIES for k in KINDS]

_COUNT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import reduced_config
from repro_torch.launch.dryrun import compile_step, lower_step, shallow_pair
from repro_torch.launch.mesh import AbstractMesh, fake_ranks
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
torch.set_num_threads(2)
spec = json.loads(sys.argv[1])

def numbers(c):
    cost, m = c.cost_analysis(), c.memory_analysis()
    return [cost["flops"], cost["bytes accessed"], m.temp_size_in_bytes,
            m.argument_size_in_bytes, m.output_size_in_bytes,
            m.alias_size_in_bytes]

out = {}
with fake_ranks():
    for family, arch in spec["families"].items():
        cfg = reduced_config(arch)
        p = max(1, cfg.cross_attn_every or 0, cfg.shared_attn_every or 0)
        cfg = dataclasses.replace(cfg, n_layers=6 * p)
        for kind in spec["kinds"]:
            shape = ShapeSpec(f"cell_{kind}", spec["s"], spec["b"], kind)
            for name, dims in spec["meshes"].items():
                mesh = AbstractMesh(tuple(zip(("data", "model"), dims)))
                pair = shallow_pair(cfg, shape, mesh, DEFAULT_RULES, "full")
                ext = compile_step(cfg, shape, mesh, DEFAULT_RULES, "full",
                                   pair=pair)
                low = lower_step(cfg, shape, mesh, DEFAULT_RULES)
                full = low.compile()
                again = pair[0].lowered.compile()
                e, c = ext.collectives(), full.collectives()
                row = out[f"{family}/{kind}/{name}"] = {
                    "extrapolated": [e.counts, e.bytes_by_kind,
                                     e.total_bytes],
                    "full": [c.counts, c.bytes_by_kind, c.total_bytes],
                    "cost": [numbers(ext), numbers(full)],
                    "shallow": [numbers(x) for x in pair],
                    "twice": [numbers(pair[0]), numbers(again)]}
                if name == "2x2":
                    row["global_flops"] = low.trace().flops
            one = AbstractMesh((("data", 1), ("model", 1)))
            if family == "hybrid" and kind == "train":
                # a batch small enough that past 4p the peak moves from
                # the backward into the optimizer, whose temporaries of
                # the depth-stacked leaves grow faster
                deep = dataclasses.replace(cfg, n_layers=7 * p)
                small = ShapeSpec("small_train", spec["s"], 4, "train")
                mesh = AbstractMesh((("data", 2), ("model", 2)))
                out["small"] = [
                    numbers(compile_step(deep, small, mesh, DEFAULT_RULES,
                                         "full")),
                    numbers(lower_step(deep, small, mesh,
                                       DEFAULT_RULES).compile())]
            low = lower_step(cfg, shape, one, DEFAULT_RULES)
            t = low.trace()
            out[f"{family}/{kind}/1x1"] = {
                "compiled": numbers(compile_step(cfg, shape, one,
                                                 DEFAULT_RULES, "full")),
                "global": [t.flops, t.bytes, t.temp_bytes]}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    spec = {"families": FAMILIES, "kinds": KINDS, "meshes": MESHES,
            "b": B, "s": S}
    proc = subprocess.run([sys.executable, "-c", _COUNT, json.dumps(spec)],
                          capture_output=True, text=True, timeout=900,
                          env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("family,kind,mesh", CASES)
def test_two_depth_extrapolation_equals_the_full_depth_count(
        counts, family, kind, mesh):
    got = counts[f"{family}/{kind}/{mesh}"]
    (e_counts, e_bytes, e_total), (f_counts, f_bytes, f_total) = \
        got["extrapolated"], got["full"]
    assert e_counts == f_counts
    assert e_bytes == f_bytes
    assert e_total == f_total
    assert f_counts.get("all-gather", 0) > 0 and f_total > 0


@pytest.mark.parametrize("family,kind,mesh", CASES)
def test_two_depth_extrapolation_equals_the_full_depth_cost(
        counts, family, kind, mesh):
    """FLOPs, bytes accessed, temp and argument, output and alias bytes
    per device exact at 6p; a serving step's temp peak is one layer's
    working set from 2p on, flat but for what grows with the depth (the
    vlm prefill's gathered cross-attention stack), which the line from 2p
    through 3p takes."""
    got = counts[f"{family}/{kind}/{mesh}"]
    (ext, full), (c2, c3) = got["cost"], got["shallow"]
    assert ext == full
    assert all(n > 0 for n in full[:2])
    if kind == "train":
        assert c2[2] < c3[2] < full[2]


def test_train_temp_extrapolation_is_a_lower_bound(counts):
    """A train step's temp peak at full depth is the larger of its
    backward's and its optimizer's, each growing linearly with the depth
    at its own rate; where the optimizer's overtakes past 3p (reduced
    zamba2 at B 4 on 2 x 2, 7p layers), the line through 2p and 3p falls
    short of the full count.  FLOPs, bytes and the memory sizes stay
    exact."""
    ext, full = counts["small"]
    assert ext[:2] == full[:2] and ext[3:] == full[3:]
    assert ext[2] < full[2]


@pytest.mark.parametrize("family,kind,mesh", CASES)
def test_a_step_counted_twice_gives_equal_numbers(counts, family, kind,
                                                  mesh):
    first, second = counts[f"{family}/{kind}/{mesh}"]["twice"]
    assert first == second


@pytest.mark.parametrize("family,kind", [(f, k) for f in ("dense", "vlm",
                                                          "moe")
                                         for k in KINDS])
def test_a_rank_counts_its_own_flops_not_a_quarter_of_the_global(
        counts, family, kind):
    """Dense and vlm ranks split every product four ways; an MoE rank
    routes the whole batch and so runs more than a quarter."""
    got = counts[f"{family}/{kind}/2x2"]
    rank, quarter = got["cost"][1][0], got["global_flops"] / 4
    if family == "moe":
        assert rank > 1.2 * quarter
    else:
        assert rank == quarter


@pytest.mark.parametrize("family,kind", CELLS)
def test_one_device_takes_the_global_trace(counts, family, kind):
    got = counts[f"{family}/{kind}/1x1"]
    assert got["compiled"][:3] == got["global"]
