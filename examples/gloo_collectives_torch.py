"""Which collectives gloo takes for tensors on one shared card.

Four ranks on one device cannot use NCCL ("Duplicate GPU detected"), so
the port's ranks that share the H100 run over gloo.  This script starts
four spawned ranks (``repro_torch.launch.ranks.run_ranks``) for each
collective, each in a fresh group so that a rank that crashes takes only
that case with it, and prints one JSON line per case: the c10d collectives
(``torch.distributed.all_reduce`` and the others, called synchronously)
and the functional ones that DTensor's redistribution dispatches
(``torch.ops._c10d_functional.*``, then ``wait_tensor``), in f32 and bf16,
with their results checked; then the same functional all-gather and a set
of DTensor redistributions with ``sharding.collectives.stage_through_host``
in place.

    python3 examples/gloo_collectives_torch.py            # on the card
    PYTHONPATH=src python examples/gloo_collectives_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

WORLD = 4
CASES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
         "all_to_all_single", "broadcast",
         "functional.all_reduce", "functional.all_gather_into_tensor",
         "functional.reduce_scatter_tensor", "functional.all_to_all_single",
         "staged.all_gather_into_tensor", "staged.dtensor")


def _case(rank: int, case: str, device: str) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.sharding.collectives import STAGED, stage_through_host
    torch.set_num_threads(1)
    if case.startswith("staged."):
        stage_through_host()
    fc = torch.ops._c10d_functional
    group = dist.group.WORLD.group_name
    total = sum(range(1, WORLD + 1))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((8, 4), float(rank + 1), dtype=dtype, device=device)
        big = torch.full((8 * WORLD, 4), float(rank + 1), dtype=dtype,
                         device=device)
        if case == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            ok = float(y[0, 0]) == total
        elif case == "all_gather_into_tensor":
            y = torch.empty_like(big)
            dist.all_gather_into_tensor(y, x)
            ok = float(y[-1, 0]) == WORLD
        elif case == "reduce_scatter_tensor":
            y = torch.empty_like(x)
            dist.reduce_scatter_tensor(y, big)
            ok = float(y[0, 0]) == total
        elif case == "all_to_all_single":
            src = torch.full((2 * WORLD,), float(rank), dtype=dtype,
                             device=device)
            y = torch.empty_like(src)
            dist.all_to_all_single(y, src)
            ok = y.cpu().tolist() == [float(r) for r in range(WORLD)
                                      for _ in range(2)]
        elif case == "broadcast":
            y = x.clone()
            dist.broadcast(y, 0)
            ok = float(y[0, 0]) == 1
        elif case == "functional.all_reduce":
            y = fc.wait_tensor(fc.all_reduce(x, "sum", group))
            ok = float(y[0, 0]) == total
        elif case in ("functional.all_gather_into_tensor",
                      "staged.all_gather_into_tensor"):
            y = fc.wait_tensor(fc.all_gather_into_tensor(x, WORLD, group))
            ok = float(y[-1, 0]) == WORLD
        elif case == "functional.reduce_scatter_tensor":
            y = fc.wait_tensor(fc.reduce_scatter_tensor(big, "sum", WORLD,
                                                        group))
            ok = float(y[0, 0]) == total
        elif case == "functional.all_to_all_single":
            src = torch.full((2 * WORLD,), float(rank), dtype=dtype,
                             device=device)
            split = [2] * WORLD
            y = fc.wait_tensor(fc.all_to_all_single(src, split, split, group))
            ok = y.cpu().tolist() == [float(r) for r in range(WORLD)
                                      for _ in range(2)]
        else:                                     # staged.dtensor
            mesh = init_device_mesh(device, (2, WORLD // 2),
                                    mesh_dim_names=("data", "model"))
            full = torch.arange(64 * 16, dtype=torch.float32).reshape(
                64, 16).to(dtype)
            d = distribute_tensor(full.to(device), mesh, [Shard(0), Shard(1)],
                                  src_data_rank=None)
            whole = d.redistribute(mesh, [Replicate(), Replicate()])
            swapped = d.redistribute(mesh, [Shard(1), Shard(0)])
            p = DTensor.from_local(torch.ones(4, 4, dtype=dtype,
                                              device=device),
                                   mesh, [Partial(), Partial()])
            ok = (torch.equal(whole.to_local().cpu(), full)
                  and torch.equal(swapped.full_tensor().cpu(), full)
                  and float(p.full_tensor()[0, 0]) == WORLD)
        out[str(dtype).replace("torch.", "")] = bool(ok)
        if device == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
    out["staged"] = {k: dict(v) for k, v in STAGED.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from repro_torch.launch.ranks import run_ranks
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu)")
    for case in CASES:
        if args.device == "cpu" and case.startswith("staged."):
            continue                   # the staged path is CUDA's only
        try:
            ranks = run_ranks(_case, WORLD, case, args.device,
                              device=args.device, timeout=120)
            r = {"ok": all(v for r in ranks for k, v in r.items()
                           if k != "staged"),
                 "by_dtype": {k: v for k, v in ranks[0].items()
                              if k != "staged"},
                 "staged": ranks[0]["staged"]}
        except Exception as e:          # a crashed rank: the finding
            r = {"ok": False, "error": f"{type(e).__name__}: "
                                       f"{str(e).strip()[-200:]}"}
        print(json.dumps({"case": case, "device": args.device,
                          "torch": torch.__version__, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
