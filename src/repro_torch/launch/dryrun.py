"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on ``meta``
tensors and compute its roofline (torch; counterpart of
``repro.launch.dryrun``).  For each cell:

    lowered  = lower_train_step / lower_prefill / lower_serve_step(...)
    compiled = lowered.compile()          # one run of the step on meta
    memory_analysis / cost_analysis -> results JSON
    collectives: one rank's step counted at depths p and 2p, extrapolated

Results append incrementally to --out (resumable), with the reference's row
keys (``fits_hbm_80g`` in place of ``fits_hbm_16g``);
``python -m repro_torch.roofline.report`` makes the tables from that file.

Depth: XLA counts a ``while`` body once, so the reference compiles two
shallow depths and extrapolates; here a Python loop runs every layer, so
each cell's FLOPs, bytes and memory come from one global trace at full
depth.  The collectives are one rank's (``Lowered.count_collectives``:
the step run as rank 0 on ``meta`` DTensors over torch's fake group),
counted as the reference counts them: at depths p and 2p (p = max(1,
``cross_attn_every``, ``shared_attn_every``)) and extrapolated to the full
depth (``roofline.analysis.extrapolate``; the count is linear in depth).
Meshes: a mesh is ``launch.mesh.abstract_mesh`` (axis names and sizes),
counted on a ``DeviceMesh`` of its axes over one fake group of 512 ranks
that serves both meshes (``launch.mesh.rank_mesh``), so ``--mesh both``
runs in one process; and since the global trace does not depend on the
mesh, each (arch, shape, variant, remat) is traced once a process and its
counts shared by the meshes.  A row's ``trace_s`` is that trace's time,
``count_s`` its mesh's count's.  No device is used: all of it runs on the
host, at full width.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

from ..configs import CONFIGS, SHAPES, get_config
from ..roofline.analysis import LINK_BW, analyze, extrapolate
from ..sharding.rules import mesh_size
from .mesh import abstract_mesh, fake_ranks

DEFAULT_OUT = Path("dryrun_results.json")


def mesh_for(name: str):
    if name == "single":
        return abstract_mesh(multi_pod=False)
    if name == "multi":
        return abstract_mesh(multi_pod=True)
    raise ValueError(name)


def rules_for(arch: str, shape_name: str, variant: str = "baseline"):
    """Per-cell sharding rules.  ``variant`` may be '+'-composed, e.g.
    'pure_fsdp+chunked_loss'; 'chunked_loss' toggles the CE impl instead of
    the rules (handled by the caller)."""
    from ..sharding import DEFAULT_RULES
    rules = dict(DEFAULT_RULES)
    if shape_name == "long_500k":
        # batch=1: sequence-shard the cache over the data axis
        rules["cache_seq"] = "data"
        rules["cache_batch"] = None
    for v in variant.split("+"):
        if v in ("baseline", "chunked_loss") or v.startswith("micro"):
            continue
        from .variants import apply_variant
        rules = apply_variant(rules, arch, shape_name, v)
    return rules


def loss_for(variant: str) -> str:
    return "chunked" if "chunked_loss" in variant.split("+") else "dense"


def micro_for(variant: str) -> int:
    for v in variant.split("+"):
        if v.startswith("micro"):
            return int(v[5:])
    return 1


def lower_step(cfg, shape, mesh, rules, remat="full", unroll=1,
               loss_impl="dense", microbatches=1):
    """The step of ``shape``'s kind lowered on ``mesh`` (a
    ``roofline.trace.Lowered``)."""
    if shape.kind == "train":
        from ..train.train_step import lower_train_step
        return lower_train_step(cfg, shape, mesh, rules, remat=remat,
                                unroll=unroll, loss_impl=loss_impl,
                                microbatches=microbatches)
    if shape.kind == "prefill":
        from ..serve.serve_step import lower_prefill
        return lower_prefill(cfg, shape, mesh, rules, unroll=unroll)
    from ..serve.serve_step import lower_serve_step
    return lower_serve_step(cfg, shape, mesh, rules, unroll=unroll)


def _compile_cost(cfg, shape, mesh, rules, remat, loss_impl="dense",
                  microbatches=1, trace=None):
    """(compiled, flops, bytes) of one trace on ``mesh``, per device
    (``trace``: an earlier run of the same step, reused)."""
    compiled = lower_step(cfg, shape, mesh, rules, remat,
                          loss_impl=loss_impl,
                          microbatches=microbatches).compile(trace)
    cost = compiled.cost_analysis()
    return (compiled, float(cost["flops"]), float(cost["bytes accessed"]))


def count_collectives(cfg, shape, mesh, rules, remat, loss_impl="dense",
                      microbatches=1):
    """(collectives, their total bytes) of one rank's step at full depth:
    counted at depths p and 2p and extrapolated, the total clamped to be
    monotone in depth, as the reference's ``run_cell`` does."""
    p = max(1, cfg.cross_attn_every or 0, cfg.shared_attn_every or 0)
    c1, c2 = (lower_step(dataclasses.replace(cfg, n_layers=n), shape, mesh,
                         rules, remat, loss_impl=loss_impl,
                         microbatches=microbatches).count_collectives()
              for n in (p, 2 * p))
    coll = extrapolate(c1, c2, p, 2 * p, cfg.n_layers)
    scale = (cfg.n_layers - p) / p
    total = max(c1.total_bytes,
                c1.total_bytes + (c2.total_bytes - c1.total_bytes) * scale)
    return coll, total


def run_cell(arch: str, shape_name: str, mesh_name: str,
             variant: str = "baseline", remat: str = "full",
             traces: Optional[dict] = None):
    """One dry-run cell: the step traced once at full depth, its memory
    analysis on this cell's mesh, one rank's collectives
    (``count_collectives``) and the roofline.  ``traces`` (a dict the
    caller keeps) holds each (arch, shape, variant, remat)'s trace, so
    that a cell on another mesh reuses it."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape_name in cfg.skip_shapes:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped",
                "reason": "full-attention arch skips long_500k (DESIGN.md)"}
    mesh = mesh_for(mesh_name)
    chips = mesh_size(mesh)
    rules = rules_for(arch, shape_name, variant)
    loss_impl = loss_for(variant)
    micro = micro_for(variant)
    key = (arch, shape_name, variant, remat)
    traces = {} if traces is None else traces
    t0 = time.time()
    try:
        compiled, flops, nbytes = _compile_cost(
            cfg, shape, mesh, rules, remat, loss_impl, micro,
            trace=traces.get(key))
        traces[key] = compiled.trace
        t1 = time.time()
        coll, coll_bytes = count_collectives(cfg, shape, mesh, rules, remat,
                                             loss_impl, micro)
        count_s = time.time() - t1
        mem = compiled.memory_analysis()
        mem_stats = {}
        for attr in ("argument_size_in_bytes", "output_size_in_bytes",
                     "temp_size_in_bytes", "alias_size_in_bytes"):
            mem_stats[attr] = int(getattr(mem, attr))
        live = (mem_stats["argument_size_in_bytes"]
                + mem_stats["temp_size_in_bytes"]
                + mem_stats["output_size_in_bytes"]
                - mem_stats["alias_size_in_bytes"])
        mem_stats["bytes_per_device"] = live
        roof = analyze(arch, shape, mesh_name, chips,
                       {"flops": flops, "bytes accessed": nbytes},
                       coll, cfg, mem_stats)
        roof.collective_gbytes = coll_bytes / 1e9
        roof.collective_s = coll_bytes / LINK_BW
        row = roof.row()
        row.update({
            "status": "ok", "variant": variant, "remat": remat,
            "compile_s": round(time.time() - t0, 1),
            "trace_s": round(compiled.trace.seconds, 1),
            "count_s": round(count_s, 1),
            "memory": mem_stats,
            "kind": shape.kind,
            "params_b": round(cfg.param_count() / 1e9, 3),
            "active_params_b": round(cfg.active_param_count() / 1e9, 3),
        })
        return row
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "variant": variant, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
                "compile_s": round(time.time() - t0, 1)}


def load_results(path: Path):
    if path.exists():
        return json.loads(path.read_text())
    return []


def save_results(path: Path, rows):
    path.write_text(json.dumps(rows, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi",
                                                         "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells already in --out")
    args = ap.parse_args(argv)

    archs = list(CONFIGS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    rows = load_results(args.out)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("variant", "baseline"))
            for r in rows if r.get("status") in ("ok", "skipped")}
    with fake_ranks():                 # one group counts every cell
        for arch in archs:
            for shape in shapes:
                traces: dict = {}      # this (arch, shape)'s, for both meshes
                for mesh in meshes:
                    key = (arch, shape, mesh, args.variant)
                    if key in done and not args.force:
                        continue
                    print(f"[dryrun] {arch} × {shape} × {mesh} "
                          f"({args.variant}) ...", flush=True)
                    row = run_cell(arch, shape, mesh, args.variant, args.remat,
                                   traces)
                    print(f"  -> {row.get('status')} "
                          f"({row.get('compile_s', '?')}s) "
                          f"dominant={row.get('dominant', '-')}", flush=True)
                    rows = [r for r in rows
                            if (r["arch"], r["shape"], r["mesh"],
                                r.get("variant", "baseline")) != key]
                    rows.append(row)
                    save_results(args.out, rows)
    bad = [r for r in rows if r.get("status") == "error"]
    print(f"[dryrun] {len(rows)} cells recorded, {len(bad)} errors")
    for r in bad:
        print("  ERROR:", r["arch"], r["shape"], r["mesh"], "-", r["error"])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
