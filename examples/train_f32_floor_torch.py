#!/usr/bin/env python3
"""How the f32 gradient gap of a train step grows with depth (H100).

For each model named (default zamba2-1.2b and mamba2-370m) at full width
(random weights from seed 0, cast to f32; one batch of 4 x 1024 random
tokens, ``chip_smoke.random_batch``: frame embeddings for musicgen), cut to
its first 1, 2, 4, 6, 12, 24 layers and to full depth, the script prints
the loss and the worst leaf's relative L2 gradient error of one step
(remat "full", dense loss) for:

  * kernels against plain versions (``force_ref``);
  * kernels against a second kernel run (the atomics' order varies);
  * the floor: plain versions with the SSD over 128-step chunks and flash
    over 256-key blocks (``chip_smoke.plain_blocks``; the same function,
    other summation orders) against plain versions.

``chip_smoke.check_train`` holds an ssm / hybrid full-depth f32 step within
twice the floor and the ``F32_TRAIN_DEPTH``-layer cut within 1e-4; it holds
musicgen's f32 step at 1e-4 but for layer 0's attention-norm row, whose
gradient passes through the bf16 frame embeddings' layer.

    python3 examples/train_f32_floor_torch.py
    python3 examples/train_f32_floor_torch.py musicgen-large qwen3-1.7b

Each line is one JSON object; the card's name and power limit come first.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from chip_smoke import (cut_depth, grad_gap, init_model, plain_floor,  # noqa: E402
                        random_batch, tree_to)
from repro_torch.train.train_step import make_value_and_grad  # noqa: E402

DEPTHS = (1, 2, 4, 6, 12, 24)


def main() -> int:
    if not torch.cuda.is_available():
        print("train_f32_floor_torch: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in sys.argv[1:] or ("zamba2-1.2b", "mamba2-370m"):
        cfg, params = init_model(arch)
        batch = random_batch(cfg)
        for depth in DEPTHS + (cfg.n_layers,):
            c, cut = cut_depth(cfg, params, depth)
            p = tree_to(cut, lambda t: t.float())
            plain = make_value_and_grad(c, remat="full", force_ref=True)(
                p, batch)
            kern = make_value_and_grad(c, remat="full")(p, batch)
            k_loss, k_errs = grad_gap(kern, plain)
            _, r_errs = grad_gap(make_value_and_grad(c, remat="full")(
                p, batch), kern)
            del kern
            f_loss, f_errs = grad_gap(plain_floor(c, p, batch), plain)
            print(json.dumps({
                "arch": arch, "depth": depth, "loss_rel_err": k_loss,
                "worst_grad_rel_l2": max(k_errs.values()),
                "worst_leaf": max(k_errs, key=k_errs.get),
                "repeat_worst_grad_rel_l2": max(r_errs.values()),
                "floor_loss_rel_err": f_loss,
                "floor_worst_grad_rel_l2": max(f_errs.values()),
                "floor_worst_leaf": max(f_errs, key=f_errs.get)}),
                flush=True)
            del p, plain
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
