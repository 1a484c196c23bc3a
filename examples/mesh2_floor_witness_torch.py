#!/usr/bin/env python3
"""How far a 2 x 2 mesh's bf16 steps lie from one device's, over several
weight draws (H100, four ranks sharing the card over gloo).

For each model and seed of ``PLAN`` (each drawn at its ``chip_smoke``
2 x 2 depth, ``MESH2_RUNS``, from that seed), the parent computes the
unmeshed references as ``chip_smoke.mesh2_references`` does (the kernels'
steps, the plain versions' and the same steps on the weights cast to f32:
a 4 x 1024 prefill, the path's decode steps and the first train step's
loss and grad norm), then four ranks run the same steps on a (2, 2)
("data", "model") mesh under ``DEFAULT_RULES``.  Each line gives, for the
prefill and decode logits (largest absolute gap), the first loss and the
first grad norm:

  * ``mesh_vs_kernels``: the mesh against the unmeshed kernels;
  * ``mesh_vs_f32``: the mesh against the f32 evaluation;
  * ``kernels_vs_f32``, ``plain_vs_f32``, ``kernels_vs_plain``: the
    unmeshed bf16 evaluations' own gaps;

and the verdict of two rules at ``FLOOR_FACTOR`` (2): the mesh against the
kernels within twice the larger of kernels-vs-plain and kernels-vs-f32
(``against_kernels``), and the mesh against the f32 evaluation within twice
the largest of the three one-device gaps (``against_f32``), each plus one
ulp of the value.

The first draw of each model in ``TIMED`` also times four train steps on
the ranks, the first and third under ``CollectiveTally`` (CommDebugMode),
the second and fourth without: the first step's time is what
``chip_smoke``'s 2 x 2 paths print as a rank's train step.

    python3 examples/mesh2_floor_witness_torch.py

Each line is one JSON object; the card's name and power limit come first.
"""
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from chip_smoke import (AUDIO, FLOOR_FACTOR, MESH2_RUNS, MESH2_SHAPE,  # noqa: E402
                        MESH_TRAIN_STEPS, close_enough, gap, mesh2_assemble,
                        mesh2_local, mesh2_placed, mesh2_references,
                        mesh2_state, mesh2_weights, mesh_feed, mesh_inputs,
                        phase_build, phase_device, tree_to)

PLAN = (("mamba2-370m", (0, 1, 2, 3, 4, 5)), ("zamba2-1.2b", (0, 1)),
        (AUDIO, (0,)))
TIMED = ("mamba2-370m", AUDIO)


def witness_rank(rank: int, job: dict) -> list:
    """One rank's steps of every draw of ``job["draws"]``: this rank's
    prefill and decode logits blocks, the first train step's loss and grad
    norm, and (``job["timed"]``) four train steps' host ms."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    from repro_torch.sharding import DEFAULT_RULES
    from repro_torch.sharding.collectives import (CollectiveTally,
                                                  stage_through_host)
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage_through_host()
    mesh = make_mesh(MESH2_SHAPE, ("data", "model"), "cuda")
    out = []
    for arch, seed in job["draws"]:
        run = MESH2_RUNS[arch]
        cfg, params = mesh2_placed(mesh, arch, torch.bfloat16, run.depth,
                                   DEFAULT_RULES, seed)
        inputs, toks, batches = mesh_inputs(cfg)
        prefill = make_prefill(cfg, mesh, DEFAULT_RULES)
        step = make_serve_step(cfg, mesh, DEFAULT_RULES)
        train = make_train_step(cfg, AdamWConfig(
            total_steps=MESH_TRAIN_STEPS), mesh, DEFAULT_RULES, remat="full")
        r = {"prefill": mesh2_local(prefill(params, **inputs)), "decode": []}
        state = mesh2_state(cfg, params, inputs)
        for i in range(run.decode_steps):
            lg, state = step(params, state, **mesh_feed(cfg, toks, i))
            r["decode"].append(mesh2_local(lg))
        del state
        p = tree_to(params, torch.clone)
        opt = init_state(p)
        r["train_ms"] = []
        timed = [arch, seed] in job["timed"]
        for tallied in (True, False, True, False) if timed else (True,):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CollectiveTally() if tallied else contextlib.nullcontext():
                p, opt, m = train(p, opt, batches[0])
            torch.cuda.synchronize()
            r["train_ms"].append({"tallied": tallied,
                                  "ms": (time.perf_counter() - t0) * 1e3})
            if "loss" not in r:
                r["loss"] = float(m["loss"].full_tensor())
                r["grad_norm"] = float(m["grad_norm"].full_tensor())
        del params, p, opt, m
        torch.cuda.empty_cache()
        out.append(r)
    return out


def ulp32(x: float) -> float:
    return float(np.spacing(np.float32(abs(x))))


def verdicts(arch: str, ref: dict, ranks: list, i: int) -> dict:
    """The gaps and both rules' verdicts of draw ``i`` (module
    docstring)."""
    from repro_torch.configs import get_config
    B, S, V = 4, 1024, get_config(arch).vocab
    pre = mesh2_assemble([r[i]["prefill"] for r in ranks], (B, S, V))
    dec = [mesh2_assemble([r[i]["decode"][j] for r in ranks], (B, 1, V))
           for j in range(MESH2_RUNS[arch].decode_steps)]
    f32 = ref["f32_eval"]
    kvp, kf, pf = (ref["floor_kernels_vs_plain"], ref["floor_bf16_vs_f32"],
                   ref["floor_plain_vs_f32"])
    out = {}
    for k, got, kern, exact in (("prefill", [pre], [ref["prefill"]],
                                 [f32["prefill"]]),
                                ("decode", dec, ref["decode"], f32["decode"])):
        old = FLOOR_FACTOR * max(kvp[k], kf[k])
        new = FLOOR_FACTOR * max(kvp[k], kf[k], pf[k])
        mk = max(gap(a, b) for a, b in zip(got, kern))
        mf = max(gap(a, b) for a, b in zip(got, exact))
        out[k] = {"mesh_vs_kernels": mk, "mesh_vs_f32": mf,
                  "kernels_vs_f32": kf[k], "plain_vs_f32": pf[k],
                  "kernels_vs_plain": kvp[k],
                  "against_kernels": all(close_enough(
                      a.cuda(), b.cuda(), old, torch.bfloat16)[0]
                      for x, y in zip(got, kern) for a, b in zip(x, y)),
                  "against_f32": all(close_enough(
                      a.cuda(), b.float().cuda(), new, torch.bfloat16)[0]
                      for x, y in zip(got, exact) for a, b in zip(x, y))}
    for k, m, kern, exact in (
            ("first_loss", ranks[0][i]["loss"], ref["losses"][:1],
             f32["losses"][0]),
            ("first_grad_norm", ranks[0][i]["grad_norm"],
             ref["first_grad_norms"], f32["grad_norms"][0])):
        old = FLOOR_FACTOR * max(kvp[k], kf[k]) + ulp32(max(kern))
        new = FLOOR_FACTOR * max(kvp[k], kf[k], pf[k]) + ulp32(exact)
        mk = max(abs(m - n) for n in kern)
        out[k] = {"mesh": m, "kernels": kern, "f32": exact,
                  "mesh_vs_kernels": mk, "mesh_vs_f32": abs(m - exact),
                  "kernels_vs_f32": kf[k], "plain_vs_f32": pf[k],
                  "kernels_vs_plain": kvp[k],
                  "against_kernels": mk <= old,
                  "against_f32": abs(m - exact) <= new}
    return out


def main() -> int:
    from repro_torch.launch.ranks import run_ranks
    if not torch.cuda.is_available():
        print("mesh2_floor_witness_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, seeds in PLAN:
        t0 = time.perf_counter()
        depth = MESH2_RUNS[arch].depth
        refs = []
        for seed in seeds:
            cfg, params = mesh2_weights(arch, torch.bfloat16, depth,
                                        seed=seed)
            inputs, toks, batches = mesh_inputs(cfg)
            refs.append(mesh2_references(cfg, params, inputs, toks, batches,
                                         torch.bfloat16))
            del params, inputs, batches
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ranks = run_ranks(witness_rank, 4, {
            "draws": [[arch, s] for s in seeds],
            "timed": [[arch, seeds[0]]] if arch in TIMED else []},
            timeout=900)
        t2 = time.perf_counter()
        for i, seed in enumerate(seeds):
            line = {"witness": "mesh2_floor", "arch": arch, "seed": seed,
                    "layers": depth, **verdicts(arch, refs[i], ranks, i),
                    "train_ms_by_rank": [r[i]["train_ms"] for r in ranks]}
            print(json.dumps(line), flush=True)
        print(json.dumps({"witness": "seconds", "arch": arch,
                          "references_s": t1 - t0, "ranks_s": t2 - t1}),
              flush=True)
        del refs, ranks
    return 0


if __name__ == "__main__":
    sys.exit(main())
