#!/usr/bin/env python3
"""Where the MoE routing gap between kernels and plain versions comes from
(H100).

One prefill forward (``make_prefill``, 4 x 1024 random tokens, random weights
from seed 0) with every kernel's plain version gives the reference routing:
each MoE layer's top-k expert set for each token.  Against it, the script
prints the routing agreement (the share of (layer, token) pairs whose sets
match), the first layer's agreement alone and the first layer where any
route differs, for:

  * all kernels;
  * one kernel at a time (the other's plain version in its place): the
    flash forward, the RMSNorm forward;
  * plain versions with one rounding of the flash kernel emulated: P
    rounded to bf16 before P V, as the wgmma kernel does;
  * plain versions with the online softmax over 256-key blocks instead of
    1024 (only the order of f32 sums changes): the floor that
    ``chip_smoke.py`` holds the kernels' routing to;
  * plain versions again (the path is deterministic: 1).

The models: granite-moe-3b-a800m in bf16 and with its weights cast to f32,
then qwen3-moe-30b-a3b (48 layers, 61 GB) in bf16.

    python3 examples/moe_routing_attribution_torch.py

Each line is one JSON object; the card's name and power limit come first.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent), str(HERE.parent / "src")]

from chip_smoke import plain_blocks, routing_agreement, routing_log, tree_to  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve.serve_step import make_prefill  # noqa: E402
from train_grad_attribution_torch import (KERNEL, PLAIN,  # noqa: E402
                                          plain_fwd_bf16_p, use)


def routes(cfg, params, tokens, force_ref):
    """``routing_log`` of one prefill; the logits are dropped."""
    with routing_log() as log:
        make_prefill(cfg, "cuda", force_ref=force_ref)(params, tokens)
    return log


def report(model, config, log, base):
    per_layer = [float((a == b).all(-1).float().mean())
                 for a, b in zip(log, base)]
    first = next((i for i, a in enumerate(per_layer) if a < 1), None)
    print(json.dumps({"model": model, "config": config,
                      "routing_agreement": routing_agreement(log, base),
                      "layer0_agreement": per_layer[0],
                      "first_layer_differing": first,
                      "per_layer": per_layer}), flush=True)


def attribute(model, cfg, params, tokens):
    base = routes(cfg, params, tokens, True)
    for config, kernels in (("all kernels", set(KERNEL)),
                            ("flash forward kernel only", {"fa_fwd"}),
                            ("RMSNorm kernel only", {"rms_fwd"})):
        use(kernels)
        report(model, config, routes(cfg, params, tokens, False), base)
    use(set(KERNEL))
    fa_ops.flash_attention_ref = plain_fwd_bf16_p
    report(model, "plain, forward with bf16 P",
           routes(cfg, params, tokens, True), base)
    fa_ops.flash_attention_ref = PLAIN["fa_fwd"]
    with plain_blocks():
        report(model, "plain, forward over 256-key blocks",
               routes(cfg, params, tokens, True), base)
    report(model, "plain again", routes(cfg, params, tokens, True), base)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_routing_attribution_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for arch, dtypes in (("granite-moe-3b-a800m", ("bf16", "f32")),
                         ("qwen3-moe-30b-a3b", ("bf16",))):
        cfg = get_config(arch)
        params = init_params(cfg,
                             torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(0)
        tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                               device="cuda")
        for dt in dtypes:
            p = params if dt == "bf16" else tree_to(params,
                                                    lambda t: t.float())
            attribute(f"{arch} {dt}", cfg, p, tokens)
            del p
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
