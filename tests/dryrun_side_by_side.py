"""One reduced dry-run cell through both packages' ``run_cell``, side by
side: the reference's (XLA's SPMD compile on 256 or 512 forced host
devices) and the port's (one trace on ``meta`` tensors).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_side_by_side.py \\
        [--arch qwen3-1.7b] [--shape train_4k] [--mesh single]

Both run the arch's reduced config (``configs.reduced_config``) at the
named shape (``train_4k`` is 256 x 4096), each in a process of its own (the
reference's must import ``repro.launch.dryrun`` before JAX starts, which
forces the host devices).  Prints each row as JSON, then a table of the
keys both rows hold, and each side's seconds.  The two sides' constants
differ (the reference's v5e numbers, the port's H100 SXM ones), so the
time terms differ by design; FLOPs, bytes and memory compare directly.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CELL = r"""
import json, sys
pkg, arch, shape, mesh = sys.argv[1:5]
if pkg == "repro":
    import repro.launch.dryrun as d          # forces the host devices first
    from repro.configs import reduced_config
else:
    import repro_torch.launch.dryrun as d
    from repro_torch.configs import reduced_config
d.get_config = reduced_config
row = d.run_cell(arch, shape, mesh)
row.pop("trace", None)
print(json.dumps(row, default=str))
"""


def run(pkg: str, args) -> tuple:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", CELL, pkg, args.arch, args.shape, args.mesh],
        capture_output=True, text=True, env=env, cwd=str(ROOT))
    if proc.returncode != 0:
        raise SystemExit(f"{pkg}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), \
        time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--shape", default="train_4k",
                    choices=["train_4k", "prefill_32k", "decode_32k",
                             "long_500k"])
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()
    rows = {pkg: run(pkg, args) for pkg in ("repro", "repro_torch")}
    for pkg, (row, seconds) in rows.items():
        print(pkg, f"{seconds:.1f} s", json.dumps(row))
    ref, port = rows["repro"][0], rows["repro_torch"][0]
    print("| key | repro | repro_torch |\n|---|---|---|")
    for k in ref:
        if k in port and not isinstance(ref[k], (dict, list)):
            print(f"| {k} | {ref[k]} | {port[k]} |")
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "bytes_per_device"):
        print(f"| memory.{k} | {ref['memory'].get(k)} | "
              f"{port['memory'].get(k)} |")
    print(f"| collectives | {ref['collectives']} | {port['collectives']} |")


if __name__ == "__main__":
    main()
