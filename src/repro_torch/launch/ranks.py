"""Start the ranks of a step across processes (torch).

``run_ranks(fn, world, *args)`` runs ``fn(rank, *args)`` in ``world``
processes of their own, started with the ``spawn`` method (a parent that
holds CUDA cannot fork), each with a default gloo process group of
``world`` ranks over a ``FileStore`` in a fresh temporary directory (no
port to bind).  gloo serves ranks on the CPU and ranks that share one card
(NCCL refuses two ranks on one device; ranks on cards of their own, over
NCCL, are ROADMAP item 5e).  The ranks run on the card unless the caller
passes ``device="cpu"``; rank r uses card ``r % device_count()``.  Each
rank's return value comes back through a file (``torch.save``), in rank
order; a rank that raises fails the call with its traceback, and a call
that outlasts ``timeout`` seconds kills every rank and raises.  The group
is destroyed when ``fn`` returns, so no rank outlives the call.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List


def _rank_main(rank: int, fn: Callable, args: tuple, world: int,
               device: str, where: str) -> None:
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(where, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(where, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, device: str = "cuda",
              timeout: float = 600.0) -> List[Any]:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in a rank of its
    own (module docstring).  ``fn`` must be importable by name (a module's
    top-level function): the ranks are spawned."""
    import torch
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks") as where:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, world, device, where),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {world} ranks of "
                                       f"{fn.__name__} still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(where, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
