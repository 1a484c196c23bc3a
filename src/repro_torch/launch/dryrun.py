"""Multi-pod dry-run: count every (arch × shape × mesh) cell on ``meta``
tensors and compute its roofline (torch; counterpart of
``repro.launch.dryrun``).  For each cell:

    c1, c2   = lower_step(cfg at 2p and 3p layers).compile()  # one rank each
    compiled = lower_step(cfg).compile(extrapolate_trace(c1, c2, ...))
    memory_analysis / cost_analysis / collectives -> results JSON

Results append incrementally to --out (resumable), with the reference's row
keys (``fits_hbm_80g`` in place of ``fits_hbm_16g``);
``python -m repro_torch.roofline.report`` makes the tables from that file.

Per device means one rank's own step: on a mesh of more than one device,
``Lowered.compile()`` runs the step as rank 0 runs it, on ``meta``
DTensors of each argument's block over torch's fake group
(``Lowered.count``), and counts its FLOPs, bytes, temp peak and
collectives in that one run (``roofline.trace``).  As the reference does
with XLA's counts, each cell is counted at two shallow depths and
extrapolated to the full depth (``roofline.trace.extrapolate_trace``:
linear, clamped monotone), here 2p and 3p (p = max(1,
``cross_attn_every``, ``shared_attn_every``); ``depths`` says why not p
and 2p), which is exact where the depth is a multiple of p (a train
step's temp: a lower bound, ``extrapolate_trace``); a cell no deeper
than 3p is counted at its depth.  Argument, output and alias
bytes come from the full-depth arguments' and outputs' shardings.  A mesh
of one device takes the global trace at full depth instead
(``Lowered.trace``), which is one rank's step there.  Meshes: a mesh is
``launch.mesh.abstract_mesh`` (axis names and sizes), counted on a
``DeviceMesh`` of its axes over one fake group of 512 ranks that serves
both meshes (``launch.mesh.rank_mesh``), so ``--mesh both`` runs in one
process.  A row's ``trace_s`` is the time of the counted runs themselves
(the two rank runs, or the global trace), ``count_s`` the wall time of
lowering, building and running both depths, and its ``memory`` holds
the temp of each (``temp_by_depth``).  No device is used: all of it runs
on the host, at full width.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --explain --force      # the run in words
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

from ..configs import CONFIGS, SHAPES, get_config
from ..roofline.analysis import analyze
from ..roofline.trace import extrapolate_trace
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


def period(cfg) -> int:
    """The cross / shared block period, 1 without one."""
    return max(1, cfg.cross_attn_every or 0, cfg.shared_attn_every or 0)


def depths(cfg) -> tuple:
    """The two depths a mesh cell is counted at: 2p and 3p (``period``).
    At depth p a stack holds one block, and DTensor gathers a stack of one
    block as a view (the vlm's cross-attention stack, a cat from two
    blocks on), while a serving step's temp peak has not yet levelled off
    (from 2p on it holds one layer's working set); from 2p on each added
    period adds the same work, so the extrapolation from 2p and 3p is
    exact at any multiple of p (a train step's temp: a lower bound,
    ``extrapolate_trace``)."""
    p = period(cfg)
    return 2 * p, 3 * p


def shallow_pair(cfg, shape, mesh, rules, remat, loss_impl="dense",
                 microbatches=1):
    """The step compiled at ``depths``: on a mesh, one rank's count
    each."""
    return tuple(lower_step(dataclasses.replace(cfg, n_layers=n), shape,
                            mesh, rules, remat, loss_impl=loss_impl,
                            microbatches=microbatches).compile()
                 for n in depths(cfg))


def compile_step(cfg, shape, mesh, rules, remat, loss_impl="dense",
                 microbatches=1, pair=None):
    """The step at full depth, compiled: the step itself on one device
    (the global trace) or where the full depth is no deeper than 3p (one
    rank's count); else one rank's count extrapolated from depths 2p and
    3p (``pair``: ``shallow_pair``'s, reused)."""
    low = lower_step(cfg, shape, mesh, rules, remat, loss_impl=loss_impl,
                     microbatches=microbatches)
    l1, l2 = depths(cfg)
    if mesh_size(mesh) == 1 or cfg.n_layers <= l2:
        return low.compile()
    c1, c2 = pair or shallow_pair(cfg, shape, mesh, rules, remat, loss_impl,
                                  microbatches)
    return low.compile(extrapolate_trace(c1, c2, low, l1, l2, cfg.n_layers))


def run_cell(arch: str, shape_name: str, mesh_name: str,
             variant: str = "baseline", remat: str = "full",
             explain: bool = False):
    """One dry-run cell: one rank's step counted at depths 2p and 3p
    (``shallow_pair``) and extrapolated, its FLOPs, bytes, temp and
    collectives from those two runs, its memory analysis on the full-depth
    arguments' shardings, and the roofline.  ``explain``: print the run in
    words (``Compiled.as_text``: the 3p count's, on one device the global
    trace's)."""
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
    t0 = time.time()
    try:
        pair = (shallow_pair(cfg, shape, mesh, rules, remat, loss_impl,
                             micro)
                if chips > 1 and cfg.n_layers > depths(cfg)[1] else None)
        compiled = compile_step(cfg, shape, mesh, rules, remat, loss_impl,
                                micro, pair)
        count_s = time.time() - t0
        if explain:
            print((pair[1] if pair else compiled).as_text(), flush=True)
        cost = compiled.cost_analysis()
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
        if pair:                       # the temp counted at 2p and 3p
            mem_stats["temp_by_depth"] = [c.trace.temp_bytes for c in pair]
        roof = analyze(arch, shape, mesh_name, chips,
                       {"flops": float(cost["flops"]),
                        "bytes accessed": float(cost["bytes accessed"])},
                       compiled.collectives(), cfg, mem_stats)
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
    ap.add_argument("--explain", action="store_true",
                    help="print each cell's run in words: FLOPs and bytes "
                         "by op, what is live at the temp peak, the "
                         "collectives (at depth 3p on a mesh)")
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
                for mesh in meshes:
                    key = (arch, shape, mesh, args.variant)
                    if key in done and not args.force:
                        continue
                    print(f"[dryrun] {arch} × {shape} × {mesh} "
                          f"({args.variant}) ...", flush=True)
                    row = run_cell(arch, shape, mesh, args.variant,
                                   args.remat, args.explain)
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
