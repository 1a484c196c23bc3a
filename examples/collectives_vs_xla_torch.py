"""One rank's step on a (2, 2) and a (1, 4) mesh, set beside XLA's: the
port's count (``Lowered.compile()`` there: the step run on ``meta``
DTensors as rank 0 of torch's fake group, ``Lowered.count``), the global
trace divided by the chips (``Lowered.trace``: what the dry-run's FLOPs,
bytes and temp were before they came from the rank's own step), the rules
an earlier checkout of the port reckoned the collectives by
(``reckon_collectives``, removed since), and XLA's (the JAX reference's
step compiled on four forced host devices: its per-device program's
collectives read by ``repro.roofline.analysis.parse_collectives``, its
``cost_analysis()`` and ``memory_analysis()``).

The reduced config of each family under train, prefill and decode (B 4 x
S 256, ``DEFAULT_RULES``, XLA with every layer unrolled so that its
program holds each layer's work).  Two tables: the collectives on the
2 x 2 mesh (calls and GB by kind, a device; an all-reduce's bytes twice
its result's, the reference's convention), and FLOPs, bytes accessed and
temp bytes a device on both meshes.  DTensor is not GSPMD: the columns are
printed side by side, not held equal.  Each part runs in a process of its
own (the JAX one with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``);
``--rules-src`` names the ``src`` directory of a checkout that still has
the rules (for example a ``git archive`` of an older commit unpacked under
``build/``), and without it that column is left out.  Host only, ~4 min.

    PYTHONPATH=src python examples/collectives_vs_xla_torch.py \\
        [--rules-src build/parent/src]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {"dense": "qwen3-1.7b", "hybrid": "zamba2-1.2b",
            "moe": "granite-moe-3b-a800m", "ssm": "mamba2-370m",
            "audio": "musicgen-large", "vlm": "llama-3.2-vision-90b"}
KINDS = ("train", "prefill", "decode")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S = 4, 256

# each part prints one JSON object: "family/kind/mesh" -> {"coll": [counts,
# bytes] (2 x 2 only), "cost": [flops, bytes accessed, temp bytes]}; the
# count's also "global": the global trace's cost over the chips
_PORT = r"""
import json, sys
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import AbstractMesh, fake_ranks
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
from repro_torch.launch.dryrun import {lower}
spec = json.loads(sys.argv[1])
out = {}
with fake_ranks():
    for family, arch in spec["families"].items():
        cfg = reduced_config(arch)
        for kind in spec["kinds"]:
            for name, dims in spec["meshes"].items():
                mesh = AbstractMesh(tuple(zip(("data", "model"), dims)))
                low = {lower}(cfg, ShapeSpec("cell", spec["s"], spec["b"],
                                             kind), mesh, DEFAULT_RULES{remat})
                out[f"{family}/{kind}/{name}"] = {body}
print("RESULT", json.dumps(out))
"""
COUNT = _PORT.replace("{lower}", "lower_step").replace("{remat}", "") \
    .replace("{body}", """(lambda c, t, n: {
                    "coll": [c.collectives().counts,
                             c.collectives().bytes_by_kind],
                    "cost": [c.cost_analysis()["flops"],
                             c.cost_analysis()["bytes accessed"],
                             c.memory_analysis().temp_size_in_bytes],
                    "global": [t.flops / n, t.bytes / n,
                               t.temp_bytes // n]})(
                    low.compile(), low.trace(), dims[0] * dims[1])""")
RULES = _PORT.replace("{lower}", "_lower").replace("{remat}", ", 'full'") \
    .replace("{body}", """(lambda c: {"coll": [c.counts, c.bytes_by_kind]})(
                    low.compile().collectives())""")
XLA = r"""
import json, sys
import jax
from repro.configs import reduced_config
from repro.models.config import ShapeSpec
from repro.roofline.analysis import parse_collectives
from repro.serve.serve_step import lower_prefill, lower_serve_step
from repro.sharding import DEFAULT_RULES
from repro.train.train_step import lower_train_step
spec = json.loads(sys.argv[1])
assert jax.device_count() == 4, jax.devices()
lower = {"train": lower_train_step, "prefill": lower_prefill,
         "decode": lower_serve_step}
out = {}
for name, dims in spec["meshes"].items():
    mesh = jax.make_mesh(tuple(dims), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for family, arch in spec["families"].items():
        cfg = reduced_config(arch)
        for kind in spec["kinds"]:
            with mesh:
                c = lower[kind](cfg, ShapeSpec("cell", spec["s"], spec["b"],
                                               kind),
                                mesh, DEFAULT_RULES,
                                unroll=cfg.n_layers).compile()
            p = parse_collectives(c.as_text())
            cost = c.cost_analysis()
            out[f"{family}/{kind}/{name}"] = {
                "coll": [p.counts, p.bytes_by_kind],
                "cost": [float(cost["flops"]), float(cost["bytes accessed"]),
                         int(c.memory_analysis().temp_size_in_bytes)]}
print("RESULT", json.dumps(out))
"""


def run(code: str, src: Path, meshes=MESHES, **env) -> dict:
    """A part's results: ``code`` in a process of its own on ``src``."""
    spec = {"families": FAMILIES, "kinds": KINDS, "meshes": meshes,
            "b": B, "s": S}
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=str(src), **env)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(spec)],
                          capture_output=True, text=True, env=full,
                          cwd=str(ROOT), timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def coll(counts: dict, nbytes: dict) -> str:
    """``kind calls / GB`` for each kind, ``none`` for none."""
    return "; ".join(f"{k} {counts[k]} / {nbytes[k] / 1e9:.6f}"
                     for k in sorted(counts)) or "none"


def cost(flops: float, nbytes: float, temp: int) -> str:
    """``MFLOP / MB accessed / temp MB``."""
    return f"{flops / 1e6:.3f} / {nbytes / 1e6:.3f} / {temp / 1e6:.3f}"


def ratios(a, b) -> str:
    """``a / b`` of FLOPs, bytes and temp, ``-`` where ``b`` has none."""
    return " / ".join(f"{x / y:.3f}" if y else "-" for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rules-src", type=Path, default=None)
    args = ap.parse_args(argv)
    count = run(COUNT, ROOT / "src")
    parts = {"count": count,
             "global / chips": {k: {"cost": v.pop("global")}
                                for k, v in count.items()}}
    if args.rules_src is not None:
        parts["rules"] = run(RULES, args.rules_src.resolve(),
                             meshes={"2x2": MESHES["2x2"]})
    parts["xla"] = run(XLA, ROOT / "src", JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=4")
    keys = list(parts["count"])
    for key in keys:
        print(json.dumps({"cell": key, "b": B, "s": S,
                          **{k: v.get(key) for k, v in parts.items()}}))
    with_coll = [k for k in parts if k != "global / chips"]
    print("| Cell (2 x 2) | " + " | ".join(with_coll) + " |")
    print("|---" * (len(with_coll) + 1) + "|")
    for key in keys:
        if key.endswith("/2x2"):
            print(f"| {key[:-4]} | " + " | ".join(
                coll(*parts[k][key]["coll"]) for k in with_coll) + " |")
    with_cost = [k for k in parts if k != "rules"]
    print()
    print("| Cell | " + " | ".join(with_cost)
          + " | count / global | count / xla |")
    print("|---" * (len(with_cost) + 3) + "|")
    for key in keys:
        c, g, x = (parts[k][key]["cost"] for k in with_cost)
        print(f"| {key} | " + " | ".join(cost(*v) for v in (c, g, x))
              + f" | {ratios(c, g)} | {ratios(c, x)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
