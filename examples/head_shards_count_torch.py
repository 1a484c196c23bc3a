"""One rank's count of a full-width train step on the 2 x 2 ("data",
"model") mesh, as the dry-run counts a cell (``lower_step(...).compile()``:
the step run on ``meta`` DTensors as rank 0 of torch's fake process group;
nothing is allocated).  For each config: temp (peak live bytes), FLOPs,
the collectives' calls and bytes by kind, the output head's boundary calls
(``lm_head`` / ``lm_head_chunk``, local operand shapes) and the
allocations whose last dimension is the vocab or a "model" rank's block
of it.

    PYTHONPATH=src python examples/head_shards_count_torch.py
    # the 2 x 2 paths' train twins at chip_smoke.py's depths (B 4 x S 1024)
    PYTHONPATH=src python examples/head_shards_count_torch.py --twins
    # another checkout's package (the counts of its tree)
    python examples/head_shards_count_torch.py --src OTHER/src --twins

Without ``--twins``: depth 2, B 4 x S 1024, the dense and the chunked
loss, qwen3-1.7b, mamba2-370m, granite-moe-3b-a800m and zamba2-1.2b.
About 5 s a config on one CPU core.
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEPTH2 = ("qwen3-1.7b", "mamba2-370m", "granite-moe-3b-a800m", "zamba2-1.2b")
TWINS = {"qwen3-1.7b": 28, "zamba2-1.2b": 14, "mamba2-370m": 8,
         "granite-moe-3b-a800m": 4, "musicgen-large": 8}  # MESH2_RUNS


def count(cfg, shape, mesh, loss: str, twin: bool) -> dict:
    from repro_torch.kernels._local import shard_calls
    from repro_torch.launch.dryrun import compile_step, lower_step, period
    from repro_torch.sharding import DEFAULT_RULES
    with shard_calls() as calls:
        if twin and cfg.n_layers % period(cfg) == 0:
            c = compile_step(cfg, shape, mesh, DEFAULT_RULES, "full")
        else:
            c = lower_step(cfg, shape, mesh, DEFAULT_RULES,
                           loss_impl=loss).compile()
    coll, mem = c.collectives(), c.memory_analysis()
    widths = {cfg.vocab, cfg.vocab // 2}
    return {
        "temp_bytes": mem.temp_size_in_bytes,
        "bytes_per_device": (mem.argument_size_in_bytes
                             + mem.temp_size_in_bytes
                             + mem.output_size_in_bytes
                             - mem.alias_size_in_bytes),
        "flops": c.cost_analysis()["flops"],
        "collectives": {k: [coll.counts[k], coll.bytes_by_kind[k]]
                        for k in sorted(coll.counts)},
        "head_calls": sorted({(n, s) for n, s in calls
                              if n.startswith("lm_head")}),
        "vocab_wide": sorted(t for t in c.trace.shapes
                             if len(t) > 1 and t[-1] in widths)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package")
    ap.add_argument("--twins", action="store_true",
                    help="the 2 x 2 paths' train twins at their depths")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import AbstractMesh, fake_ranks
    from repro_torch.models.config import ShapeSpec
    torch.set_num_threads(1)
    mesh = AbstractMesh((("data", 2), ("model", 2)))
    shape = ShapeSpec("head_train", 1024, 4, "train")
    runs = ([(a, n, "dense") for a, n in TWINS.items()] if args.twins else
            [(a, 2, loss) for a in DEPTH2 for loss in ("dense", "chunked")])
    with fake_ranks():
        for arch, depth, loss in runs:
            cfg = dataclasses.replace(get_config(arch), n_layers=depth)
            row = {"arch": arch, "depth": depth, "loss": loss,
                   **count(cfg, shape, mesh, loss, args.twins)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
