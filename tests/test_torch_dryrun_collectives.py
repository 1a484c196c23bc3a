"""The dry-run's collectives (``launch.dryrun.count_collectives``): one
rank's step counted on ``meta`` DTensors at depths p and 2p (p = max(1,
``cross_attn_every``, ``shared_attn_every``)) and extrapolated, as the
reference's ``run_cell`` extrapolates XLA's counts, against the count of
the step at full depth (``Lowered.count_collectives``).

The reduced config of each of the six families, cut to 3p layers, under
train, prefill and decode (B 32 x S 64), on a (2, 2) mesh and on the
(16, 16) production mesh, both abstract (``launch.mesh.abstract_mesh``)
and so counted as rank 0 of torch's fake process group
(``launch.mesh.rank_mesh``): the two-depth extrapolation equals the
full-depth count exactly, in calls and bytes by kind, and the step gathers
something.  The counts run in a subprocess (a default process group is
process-wide), once for the module.
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

_COUNT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import reduced_config
from repro_torch.launch.dryrun import count_collectives, lower_step
from repro_torch.launch.mesh import AbstractMesh, fake_ranks
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
torch.set_num_threads(2)
spec = json.loads(sys.argv[1])
out = {}
with fake_ranks():
    for family, arch in spec["families"].items():
        cfg = reduced_config(arch)
        p = max(1, cfg.cross_attn_every or 0, cfg.shared_attn_every or 0)
        cfg = dataclasses.replace(cfg, n_layers=3 * p)
        for kind in spec["kinds"]:
            shape = ShapeSpec(f"cell_{kind}", spec["s"], spec["b"], kind)
            for name, dims in spec["meshes"].items():
                mesh = AbstractMesh(tuple(zip(("data", "model"), dims)))
                coll, total = count_collectives(cfg, shape, mesh,
                                                DEFAULT_RULES, "full")
                full = lower_step(cfg, shape, mesh,
                                  DEFAULT_RULES).count_collectives()
                out[f"{family}/{kind}/{name}"] = {
                    "extrapolated": [coll.counts, coll.bytes_by_kind, total],
                    "full": [full.counts, full.bytes_by_kind,
                             full.total_bytes]}
print("RESULT", json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    spec = {"families": FAMILIES, "kinds": KINDS, "meshes": MESHES,
            "b": B, "s": S}
    proc = subprocess.run([sys.executable, "-c", _COUNT, json.dumps(spec)],
                          capture_output=True, text=True, timeout=600,
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
