#!/usr/bin/env python3
"""Where the bf16 gradient gap of a full-width train step comes from (H100).

One qwen3-1.7b loss-and-gradient evaluation (remat "full", dense loss, 4 x
1024 random tokens, random bf16 weights from seed 0) with every kernel's plain
version is the reference.  Against it, the script prints each leaf's worst
relative L2 gradient error (and the loss's relative error) for:

  * all kernels;
  * one kernel at a time (the others' plain versions in their place): the
    flash backward, the RMSNorm forward and backward;
  * plain versions with one rounding of a kernel emulated: P rounded to bf16
    before P V in the forward, as the wgmma kernel does; P and dS rounded to
    bf16 before their products in the backward, as the backward kernel does;
  * plain versions with the forward's online softmax over 256-key blocks
    instead of 1024 (only the order of f32 sums changes): the floor below
    which no kernel can hold these gradients;
  * plain versions again (the path is deterministic: 0).

    python3 examples/train_grad_attribution_torch.py

Each line is one JSON object; the card's name and power limit come first.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src")]

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train.train_step import make_value_and_grad  # noqa: E402

PLAIN = {"fa_fwd": fa_ops.flash_attention_ref,
         "fa_bwd": fa_ops.flash_attention_bwd_ref,
         "rms_fwd": rms_ops.rmsnorm_ref, "rms_bwd": rms_ops.rmsnorm_bwd_ref}
KERNEL = {"fa_fwd": fa_ops.flash_attention_cuda,
          "fa_bwd": fa_ops.flash_attention_bwd_cuda,
          "rms_fwd": rms_ops.rmsnorm_cuda, "rms_bwd": rms_ops.rmsnorm_bwd_cuda}


def as_kernel_signature(name):
    """The plain version of ``name`` behind the kernel wrapper's signature
    (outputs contiguous, as the kernels' are)."""
    if name == "fa_fwd":
        def f(q, k, v, *, causal, q_offset, softmax_scale, return_lse):
            o, lse = PLAIN["fa_fwd"](q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     softmax_scale=softmax_scale,
                                     return_lse=True)
            return o.contiguous(), lse
    elif name == "fa_bwd":
        def f(q, k, v, o, lse, do, *, causal, q_offset, softmax_scale):
            return PLAIN["fa_bwd"](q, k, v, o, lse, do, causal=causal,
                                   q_offset=q_offset, scale=softmax_scale)
    else:
        return PLAIN[name]
    return f


def use(kernels):
    """Route the kernel path through the kernels named in ``kernels`` and
    the plain versions elsewhere."""
    for name in PLAIN:
        fn = KERNEL[name] if name in kernels else as_kernel_signature(name)
        mod, attr = ((fa_ops, "flash_attention_cuda") if name == "fa_fwd" else
                     (fa_ops, "flash_attention_bwd_cuda") if name == "fa_bwd"
                     else (rms_ops, "rmsnorm_cuda") if name == "rms_fwd"
                     else (rms_ops, "rmsnorm_bwd_cuda"))
        setattr(mod, attr, fn)


def plain_fwd_bf16_p(q, k, v, *, causal=True, q_offset=0, block_kv=1024,
                     softmax_scale=None, return_lse=False):
    """The plain forward with P rounded to bf16 before P V (l from f32 P)."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    qg = (q.float() * scale).permute(0, 2, 1, 3).reshape(B, KV, H // KV, Sq,
                                                         hd)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kf)
    pos = torch.arange(Skv, device=q.device)
    keep = (q_offset + torch.arange(Sq, device=q.device))[:, None] >= pos
    s = torch.where(keep if causal else torch.ones_like(keep), s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = p.sum(-1, keepdim=True)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p.to(torch.bfloat16).float(),
                     vf) / lsum
    o = o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3).to(q.dtype)
    lse = (m + torch.log(lsum)).reshape(B, H, Sq)
    return (o, lse) if return_lse else o


def plain_bwd_bf16_p_ds(q, k, v, o, lse, do, *, causal=True, q_offset=0,
                        scale=None):
    """The plain backward with P and dS rounded to bf16 before their
    products, as the backward kernel's mma.sync operands are."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)

    def heads(t, n):
        return t.float().permute(0, 2, 1, 3).reshape(B, KV, n, -1, hd)
    qf, of, dof = heads(q, G), heads(o, G), heads(do, G)
    kf, vf = heads(k, 1)[:, :, 0], heads(v, 1)[:, :, 0]
    s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kf) * scale
    pos = torch.arange(Skv, device=q.device)
    keep = (q_offset + torch.arange(Sq, device=q.device))[:, None] >= pos
    p = torch.where(keep if causal else torch.ones_like(keep),
                    torch.exp(s - lse.reshape(B, KV, G, Sq, 1)), 0.0)
    D = (dof * of).sum(-1, keepdim=True)

    def r(t):
        return t.to(torch.bfloat16).float()
    dv = torch.einsum("bkgqc,bkgqd->bkcd", r(p), dof)
    ds = p * (torch.einsum("bkgqd,bkcd->bkgqc", dof, vf) - D)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", r(ds), kf) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", r(ds), qf) * scale

    def back(t, like):
        return t.permute(0, 2, 1, 3).to(like.dtype)
    return (back(dq.reshape(B, H, Sq, hd), q), back(dk, k), back(dv, v))


def main() -> int:
    if not torch.cuda.is_available():
        print("train_grad_attribution_torch: CUDA is not available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config("qwen3-1.7b")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (4, 1025), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def run(force_ref):
        loss, grads = make_value_and_grad(cfg, remat="full",
                                          force_ref=force_ref)(params, batch)
        return float(loss), {"/".join(p): g for p, g in tree_leaves(grads)}

    base = run(True)

    def report(config, res):
        errs = {k: float((g.float() - base[1][k].float()).norm()
                         / base[1][k].float().norm()) for k, g in res[1].items()}
        worst = max(errs, key=errs.get)
        print(json.dumps({"config": config,
                          "loss_rel_err": abs(res[0] - base[0]) / base[0],
                          "worst_leaf": worst, "worst_rel_l2": errs[worst],
                          "median_rel_l2": float(np.median(list(errs.values()))),
                          "embed_rel_l2": errs["embed"]}), flush=True)

    for config, kernels in (("all kernels", set(KERNEL)),
                            ("flash forward kernel only", {"fa_fwd"}),
                            ("flash backward kernel only", {"fa_bwd"}),
                            ("RMSNorm kernels only", {"rms_fwd", "rms_bwd"})):
        use(kernels)
        report(config, run(False))
    use(set(KERNEL))
    for config, attr, fn in (
            ("plain, forward with bf16 P", "flash_attention_ref",
             plain_fwd_bf16_p),
            ("plain, backward with bf16 P and dS", "flash_attention_bwd_ref",
             plain_bwd_bf16_p_ds),
            ("plain, forward over 256-key blocks", "flash_attention_ref",
             lambda *a, **kw: PLAIN["fa_fwd"](*a, **{**kw, "block_kv": 256}))):
        setattr(fa_ops, attr, fn)
        report(config, run(True))
        fa_ops.flash_attention_ref = PLAIN["fa_fwd"]
        fa_ops.flash_attention_bwd_ref = PLAIN["fa_bwd"]
    report("plain again", run(True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
