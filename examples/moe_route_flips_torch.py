#!/usr/bin/env python3
"""How MoE route flips between kernels and plain versions spread through a
train step, over several weight draws (H100).

``chip_smoke.py`` holds a MoE train step's routes to the plain versions'
(``grad_pair``): the kernels may flip at most ROUTE_FACTOR times what the
plain path's floor (``plain_floor``: the plain flash forward over 256-key
blocks, only the order of its f32 sums changed) flips.  One flip moves its
token's hidden state by O(1); causal attention carries that to the later
tokens of its sequence, and the expert-sorted capacity order to the later
tokens of the batch, where more near-ties flip.  This script measures both
units on granite-moe-3b-a800m at full width and depth, as the check sees
it: each draw's weights from its seed, then TRAIN_STEPS + 1 AdamW steps on
random batches (the main path trains its weights in place before the
check), then one loss and its gradients (remat "full") on another random
batch, with kernels, with plain versions and with the floor, in bf16 and
with the weights cast to f32.  Each line gives, for the kernels and for the
floor against the plain run:

  * ``flipped_pairs``: (call, token) pairs whose top-k sets differ (the
    forward's calls and the remat recompute's);
  * ``first_flips``: those no earlier flip reaches (``first_flips``), with
    their calls and the plain run's k-th to (k+1)-th router probability gap
    at each;
  * the verdicts of the pairs rule (at most ROUTE_FACTOR times the floor's
    pairs, never less than one token's routes in every layer) and of the
    first-flips rule (at most ROUTE_FACTOR times the floor's first flips,
    never less than one).

The first draw's f32 plain step also runs twice: the path is deterministic
if ``plain_again_flips`` is 0.

    python3 examples/moe_route_flips_torch.py [draws]

Each line is one JSON object; the card's name and power limit come first.
"""
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from chip_smoke import (ROUTE_FACTOR, TRAIN_B, TRAIN_S, TRAIN_STEPS,  # noqa: E402
                        first_flips, phase_build, phase_device, plain_floor,
                        routing_log, tree_to)

ARCH = "granite-moe-3b-a800m"


def batch_from(cfg, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), generator=gen,
                         device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def trained(cfg, seed: int) -> dict:
    """Weights from ``seed`` after TRAIN_STEPS + 1 AdamW steps, as
    ``phase_train`` leaves them."""
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed))
    steps = TRAIN_STEPS + 1
    opt_state = init_state(params)
    step = make_train_step(cfg, AdamWConfig(total_steps=steps), remat="full")
    for i in range(steps):
        params, opt_state, _ = step(params, opt_state,
                                    batch_from(cfg, 100 * seed + i))
    del opt_state
    torch.cuda.empty_cache()
    return params


def side(log, base, margins, tokens: int) -> dict:
    sites = first_flips(base, log)
    pairs = sum(int((x != y).any(-1).sum()) for x, y in zip(log, base))
    return {"flipped_pairs": pairs, "first_flips": len(sites),
            "first_flip_calls": sorted({c for c, _ in sites}),
            "first_flip_margins": [float(margins[c][i]) for c, i in sites],
            "tokens": tokens}


def draw(cfg, seed: int) -> None:
    from repro_torch.train.train_step import make_value_and_grad
    params = trained(cfg, seed)
    batch = batch_from(cfg, 10_000 + seed)
    for dtype in ("bf16", "f32"):
        p = params if dtype == "bf16" else tree_to(params,
                                                   lambda t: t.float())
        with routing_log() as rk:
            make_value_and_grad(cfg, remat="full")(p, batch)
        margins = []
        with routing_log(margins=margins) as rp:
            make_value_and_grad(cfg, remat="full", force_ref=True)(p, batch)
        with routing_log() as rf:
            plain_floor(cfg, p, batch)
        tokens = rp[0].shape[0]
        k, f = side(rk, rp, margins, tokens), side(rf, rp, margins, tokens)
        calls = len(rp)
        pairs_limit = ROUTE_FACTOR * max(f["flipped_pairs"], calls)
        first_limit = ROUTE_FACTOR * max(f["first_flips"], 1)
        line = {"arch": ARCH, "seed": seed, "dtype": dtype, "calls": calls,
                "kernels": k, "floor": f,
                "pairs_rule": {"limit": pairs_limit,
                               "ok": k["flipped_pairs"] <= pairs_limit},
                "first_flips_rule": {"limit": first_limit,
                                     "ok": k["first_flips"] <= first_limit}}
        if dtype == "f32" and seed == 0:
            with routing_log() as rp2:
                make_value_and_grad(cfg, remat="full", force_ref=True)(
                    p, batch)
            line["plain_again_flips"] = sum(
                int((x != y).any(-1).sum()) for x, y in zip(rp2, rp))
        print(json.dumps(line), flush=True)
        del p
        torch.cuda.empty_cache()


def main() -> int:
    from repro_torch.configs import get_config
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    cfg = get_config(ARCH)
    for seed in range(draws):
        draw(cfg, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
