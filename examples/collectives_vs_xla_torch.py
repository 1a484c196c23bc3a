"""One rank's collectives on a (2, 2) mesh, three ways: the port's count
(``Lowered.count_collectives``: the step run on ``meta`` DTensors as rank
0 of torch's fake group), the rules an earlier checkout of the port
reckoned them by (``reckon_collectives``, removed since), and XLA's
(the JAX reference's step compiled on four forced host devices, its
per-device program read by ``repro.roofline.analysis.parse_collectives``).

The reduced config of each family under train, prefill and decode (B 4 x
S 256, ``DEFAULT_RULES``, XLA with every layer unrolled so that its
program holds each layer's collectives).  Calls and GB by kind, a
device; an all-reduce's bytes twice its result's (the reference's
convention).  DTensor is not GSPMD: the three are printed side by side,
not held equal.  Each part runs in a process of its own (the JAX one with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``); ``--rules-src``
names the ``src`` directory of a checkout that still has the rules (for
example a ``git archive`` of an older commit unpacked under ``build/``),
and without it that column is left out.  Host only, ~2 min.

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
B, S = 4, 256

# each part prints one JSON object: "family/kind" -> [counts, bytes]
_PORT = r"""
import json, sys
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.config import ShapeSpec
from repro_torch.sharding import DEFAULT_RULES
from repro_torch.{lower}
spec = json.loads(sys.argv[1])
mesh = AbstractMesh((("data", 2), ("model", 2)))
out = {}
for family, arch in spec["families"].items():
    cfg = reduced_config(arch)
    for kind in spec["kinds"]:
        low = lower(cfg, ShapeSpec("cell", spec["s"], spec["b"], kind), mesh,
                    DEFAULT_RULES)
        c = {how}
        out[f"{family}/{kind}"] = [c.counts, c.bytes_by_kind]
print("RESULT", json.dumps(out))
"""
COUNT = _PORT.replace("{lower}", "launch.dryrun import lower_step as lower") \
    .replace("{how}", "low.count_collectives()")
RULES = _PORT.replace("{lower}", "launch.dryrun import _lower") \
    .replace("{how}", "low.compile().collectives()") \
    .replace("low = lower(cfg", "low = _lower(cfg") \
    .replace("DEFAULT_RULES)\n        c", "DEFAULT_RULES, 'full')\n        c")
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
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
lower = {"train": lower_train_step, "prefill": lower_prefill,
         "decode": lower_serve_step}
out = {}
for family, arch in spec["families"].items():
    cfg = reduced_config(arch)
    for kind in spec["kinds"]:
        with mesh:
            c = lower[kind](cfg, ShapeSpec("cell", spec["s"], spec["b"], kind),
                            mesh, DEFAULT_RULES,
                            unroll=cfg.n_layers).compile()
        p = parse_collectives(c.as_text())
        out[f"{family}/{kind}"] = [p.counts, p.bytes_by_kind]
print("RESULT", json.dumps(out))
"""


def run(code: str, src: Path, **env) -> dict:
    """A part's results: ``code`` in a process of its own on ``src``."""
    spec = {"families": FAMILIES, "kinds": KINDS, "b": B, "s": S}
    full = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    full.update(PYTHONPATH=str(src), **env)
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(spec)],
                          capture_output=True, text=True, env=full,
                          cwd=str(ROOT), timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def cell(counts: dict, nbytes: dict) -> str:
    """``kind calls / GB`` for each kind, ``none`` for none."""
    return "; ".join(f"{k} {counts[k]} / {nbytes[k] / 1e9:.6f}"
                     for k in sorted(counts)) or "none"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rules-src", type=Path, default=None)
    args = ap.parse_args(argv)
    parts = {"count": run(COUNT, ROOT / "src")}
    if args.rules_src is not None:
        parts["rules"] = run(RULES, args.rules_src.resolve())
    parts["xla"] = run(XLA, ROOT / "src", JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=4")
    for key in parts["count"]:
        print(json.dumps({"cell": key, "mesh": "2x2", "b": B, "s": S,
                          **{k: v[key] for k, v in parts.items()}}))
    print("| Cell | " + " | ".join(parts) + " |")
    print("|---" * (len(parts) + 1) + "|")
    for key in parts["count"]:
        print(f"| {key} | " + " | ".join(cell(*v[key])
                                          for v in parts.values()) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
