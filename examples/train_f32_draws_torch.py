#!/usr/bin/env python3
"""How a full-depth f32 train step's gradient gap varies with the weights
(H100).

``chip_smoke.check_train`` holds an ssm / hybrid model's full-depth f32
step, kernels against plain versions (``force_ref``), within twice the
floor (plain versions under ``chip_smoke.plain_blocks``: the same function,
other f32 summation orders), on the weights its train path leaves.  Those
weights move from run to run (the flash backward's dQ order varies), and
the gap with them.  This script draws such weights on purpose and prints,
for each draw, the worst leaf's relative L2 gradient error of:

  * kernels against plain versions, and against a second kernel run;
  * the floor against plain versions;
  * one kernel family at a time (the others' plain versions in their
    place): the SSD chunk, flash attention, RMSNorm.

Draw s: the model at full width and depth (random bf16 weights from seed
0) takes ``--steps`` AdamW steps with plain versions on random 4 x 1024
batches from seed 100 s + k, so the draws do not depend on the kernels
(two builds of them see the same weights); it is then cast to f32 and one
more batch, from seed 100 s + 99, is evaluated.

``--main-path`` draws as ``chip_smoke.run_train`` does instead: each draw
is a fresh model trained by ``chip_smoke.phase_train`` (kernels, the
cached token pipeline) and held by ``chip_smoke.grad_pair`` in f32 on its
last batch, the check itself, then broken down as above (no breakdown
with ``--kernels-only``); the draws differ only where the kernels'
backwards do from run to run.

    python3 examples/train_f32_draws_torch.py
    python3 examples/train_f32_draws_torch.py --arch mamba2-370m --draws 4
    python3 examples/train_f32_draws_torch.py --kernels-only   # no floor
    python3 examples/train_f32_draws_torch.py --main-path --draws 8
    CUBLAS_WORKSPACE_CONFIG=:4096:8 \
        python3 examples/train_f32_draws_torch.py --main-path --nan-fill

``--nan-fill`` fills every tensor that ``torch.empty`` hands out with NaN
(``torch.utils.deterministic.fill_uninitialized_memory``, which needs
deterministic algorithms, here in warn-only mode): a kernel that reads an
element nothing wrote then returns NaN.

Each line is one JSON object; the card's name and power limit come first.
"""
import argparse
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from chip_smoke import (TRAIN_B, TRAIN_S, grad_gap, grad_pair,  # noqa: E402
                        init_model, phase_train, plain_floor, tree_to)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, apply_updates,  # noqa: E402
                                         init_state)
from repro_torch.train.train_step import make_value_and_grad  # noqa: E402

FAMILIES = {"ssd": ssd_ops, "flash": fa_ops, "rmsnorm": rms_ops}


@contextmanager
def only(family: str):
    """Inside: every kernel family but ``family`` runs its plain version on
    the card."""
    others = [m for k, m in FAMILIES.items() if k != family]
    saved = [m.PLAIN_DEVICES for m in others]
    for m in others:
        m.PLAIN_DEVICES = m.PLAIN_DEVICES + ("cuda",)
    try:
        yield
    finally:
        for m, s in zip(others, saved):
            m.PLAIN_DEVICES = s


def batch_of(cfg, seed: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), generator=gen,
                         device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def worst(errs: dict) -> dict:
    leaf = max(errs, key=errs.get)
    return {"worst": errs[leaf], "leaf": leaf}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--draws", type=int, default=6)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--kernels-only", action="store_true",
                    help="kernels against plain versions only")
    ap.add_argument("--main-path", action="store_true",
                    help="draw and hold as chip_smoke's train path does")
    ap.add_argument("--nan-fill", action="store_true",
                    help="torch.empty fills what it hands out with NaN")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_f32_draws_torch: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.nan_fill:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
    if args.main_path:
        return main_path(args.arch, args.draws, args.kernels_only)
    cfg, init = init_model(args.arch)
    plain_vg = make_value_and_grad(cfg, remat="full", force_ref=True)
    kern_vg = make_value_and_grad(cfg, remat="full")
    for s in range(args.draws):
        params = tree_to(init, lambda t: t.clone())
        opt_cfg = AdamWConfig(total_steps=args.steps)
        opt_state = init_state(params)
        for k in range(args.steps):
            _, grads = plain_vg(params, batch_of(cfg, 100 * s + k))
            apply_updates(params, grads, opt_state, opt_cfg)
            del grads
        del opt_state
        p = tree_to(params, lambda t: t.float())
        del params
        torch.cuda.empty_cache()
        batch = batch_of(cfg, 100 * s + 99)
        plain = plain_vg(p, batch)
        kern = kern_vg(p, batch)
        k_loss, k_errs = grad_gap(kern, plain)
        out = {"arch": args.arch, "draw": s, "loss_plain": float(plain[0]),
               "loss_rel_err": k_loss, "kernels": worst(k_errs)}
        if not args.kernels_only:
            out["repeat"] = worst(grad_gap(kern_vg(p, batch), kern)[1])
            f_loss, f_errs = grad_gap(plain_floor(cfg, p, batch), plain)
            out["floor"] = worst(f_errs)
            out["floor_loss_rel_err"] = f_loss
            out["ratio"] = out["kernels"]["worst"] / out["floor"]["worst"]
            for fam in FAMILIES:
                with only(fam):
                    out[f"{fam}_only"] = worst(
                        grad_gap(kern_vg(p, batch), plain)[1])
        print(json.dumps(out), flush=True)
        del p, plain, kern
        torch.cuda.empty_cache()
    return 0


def main_path(arch: str, draws: int, kernels_only: bool) -> int:
    """Each draw's ``grad_pair`` line; unless ``kernels_only``, also the
    same weights' second kernel run and each kernel family alone against
    the plain versions (``only``), as the other draws report them."""
    for s in range(draws):
        cfg, params = init_model(arch)
        tr = phase_train(cfg, params)
        p = tree_to(params, lambda t: t.float())
        del params
        torch.cuda.empty_cache()
        batch = tr["batch"]
        r = grad_pair(cfg, p, batch, torch.float32)
        out = {"arch": arch, "draw": s, "train_losses": tr["losses"],
               "ratio": r["worst_grad_rel_l2"] / r["floor_worst_grad_rel_l2"],
               **r}
        if not kernels_only:
            kern_vg = make_value_and_grad(cfg, remat="full")
            plain = make_value_and_grad(cfg, remat="full", force_ref=True)(
                p, batch)
            kern = kern_vg(p, batch)
            out["kernels"] = worst(grad_gap(kern, plain)[1])
            out["repeat"] = worst(grad_gap(kern_vg(p, batch), kern)[1])
            del kern
            for fam in FAMILIES:
                with only(fam):
                    out[f"{fam}_only"] = worst(
                        grad_gap(kern_vg(p, batch), plain)[1])
            del plain
        print(json.dumps(out), flush=True)
        del p, tr, batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
