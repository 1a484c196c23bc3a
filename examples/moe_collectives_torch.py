"""The collectives an MoE step makes across ranks, under each expert-
parallel rules variant, beside the dry-run twin's count of the same step.

Reduced granite-moe-3b-a800m (2 layers, 4 experts top-2, bf16 weights from
seed 0) runs one prefill and one train step (remat "full") of a 4 x 64
batch on a (2, 2) ("data", "model") mesh of four spawned gloo ranks on the
CPU, under ``DEFAULT_RULES`` and the ``ep_capacity``, ``expert_data`` and
``ep_only`` variants (``launch.variants``).  Rank 0 counts its collectives
in calls and bytes by kind (``sharding.collectives.CollectiveTally``); the
same steps lowered on rank 0's mesh under the same rules
(``lower_prefill``, ``lower_train_step``) and run there on ``meta``
DTensors give the twin's (``Lowered.count``: what the dry-run counts).  One JSON line a variant, with whether the two agree.  Counts
only: no time is measured.

    PYTHONPATH=src python examples/moe_collectives_torch.py     # ~30 s
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

ARCH = "granite-moe-3b-a800m"
VARIANTS = ("baseline", "ep_capacity", "expert_data", "ep_only")
B, S = 4, 64


def rank_counts(rank: int) -> dict:
    """This rank's collectives (calls, bytes by kind) of a prefill and a
    train step under each variant, measured and as the twin counts them."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.transformer import build_specs, init_params
    from repro_torch.serve.serve_step import lower_prefill, make_prefill
    from repro_torch.sharding import (DEFAULT_RULES, distribute_tree,
                                      shardings_for)
    from repro_torch.sharding.collectives import CollectiveTally
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import lower_train_step, make_train_step
    torch.set_num_threads(1)
    cfg = reduced_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    toks = torch.randint(0, cfg.vocab, (B, S + 1),
                         generator=torch.Generator().manual_seed(1)
                         ).to(torch.int32)
    out = {}
    for variant in VARIANTS:
        rules = apply_variant(DEFAULT_RULES, ARCH, "train_4k", variant)
        p = distribute_tree(params, shardings_for(build_specs(cfg), mesh,
                                                  rules))
        with CollectiveTally() as prefill:
            make_prefill(cfg, mesh, rules)(p, tokens=toks[:, :-1])
        step = make_train_step(cfg, AdamWConfig(), mesh, rules, remat="full")
        with CollectiveTally() as train:
            step(p, init_state(p), {"tokens": toks[:, :-1],
                                    "labels": toks[:, 1:]})
        twin = {"prefill": lower_prefill(cfg, ShapeSpec("p", S, B, "prefill"),
                                         mesh, rules),
                "train": lower_train_step(cfg, ShapeSpec("t", S, B, "train"),
                                          mesh, rules)}
        out[variant] = {
            kind: {"measured": tally.by_kind(),
                   "twin": (lambda c: (c.counts, c.bytes_by_kind))(
                       twin[kind].count().collectives)}
            for kind, tally in (("prefill", prefill), ("train", train))}
    return out


def main() -> None:
    from repro_torch.launch.ranks import run_ranks
    rank0 = run_ranks(rank_counts, 4, device="cpu", timeout=600)[0]
    for variant in VARIANTS:
        got = rank0[variant]
        print(json.dumps({
            "arch": ARCH, "variant": variant, "mesh": "2x2",
            "measured_rank0": {k: v["measured"] for k, v in got.items()},
            "twin": {k: v["twin"] for k, v in got.items()},
            "equal": all(tuple(v["measured"]) == tuple(v["twin"])
                         for v in got.values())}), flush=True)


if __name__ == "__main__":
    main()
