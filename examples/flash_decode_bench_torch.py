#!/usr/bin/env python3
"""Time the flash forward's ``decode`` variant (one query row) on one GPU.

    python3 examples/flash_decode_bench_torch.py [--source FILE ...]
        [--splits 1,2,4,...] [--phases]

At llama-3.2-vision-90b's decode cross-attention (q (4, 1, 64, 128) over
1601 image tokens in 8 KV heads) and a 2 x 2 rank's shard of it (q (2, 1,
32, 128) over 4 KV heads), bf16, on ``chip_smoke.py``'s inputs: each
version of ``src/repro_torch/csrc/flash_attention.cu`` (``--source``; the
default is the repo's), built by ``_build.build`` from a copy of ``csrc/``
with that file in place of the repo's, is held against
``flash_attention_ref`` at its plan and timed as ``chip_smoke.py`` times a
kernel (cold L2, median of 20) at ``plan()``'s number of key splits (CTAs
of a cluster) and at each of ``--splits`` (powers of two up to 16).
``--phases`` adds, for each version, two cut copies that time what is
left: ``no_merge`` (each CTA returns before the cluster merges the
splits) and ``no_tail`` (each CTA returns after its loads and products,
before its own merge).  Beside
them, in the same turns: the repo's ``wgmma`` variant at the same shape,
``F.scaled_dot_product_attention``, the read floor (one ``sum`` over K and
V, the bytes the kernel must read) and the launch floor (an empty
``torch.cuda._sleep(0)``).  Two rounds, the second in reverse order.
Prints the card's name and power limit, then one JSON line per (shape,
round, what was timed).
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (HBM_BYTES_PER_S, TOL, close_enough,  # noqa: E402
                        time_ms)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_attention_ref)
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    VARIANTS, plan)

SHAPES = [(4, 1601, 64, 8, 128), (2, 1601, 32, 4, 128)]   # B, Skv, H, KV, hd
# Cuts of the kernel: (text of the source, what replaces its first match).
PHASES = {"no_merge": ("  cluster.sync();  //", "  return;  //"),
          "no_tail": ("  cp_async_wait<0>();\n\n  // The warps' partials",
                      "  cp_async_wait<0>();\n  return;\n\n"
                      "  // The warps' partials")}


def build(name: str, source: Path, phase=None):
    """``flash_attn_fwd`` of a library built from a copy of csrc/ with
    ``source`` (cut by ``phase``) in place of flash_attention.cu."""
    csrc = ROOT / "build" / "flash_decode_bench" / name
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, csrc)
    shutil.copy(_build.CSRC / "common.cu", csrc)
    text = source.read_text()
    if phase is not None:
        old, new = PHASES[phase]
        if old not in text:
            raise SystemExit(f"{source}: cannot cut {phase}")
        text = text.replace(old, new, 1)
    (csrc / "flash_attention.cu").write_text(text)
    fn = ctypes.CDLL(str(_build.build(csrc))).flash_attn_fwd
    fn.argtypes, fn.restype = _build.SIGNATURES["flash_attn_fwd"]
    return fn


def launch(fn, q, k, v, o, lse, p):
    """One launch of ``fn`` with the decode plan ``p``, as
    ``flash_attention_cuda`` launches it (non-causal)."""
    B, _, H, hd = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, 1, k.shape[1], H, k.shape[2], hd, 1, 0, 0,
             1.0 / math.sqrt(hd), VARIANTS["decode"], p.block_q, p.block_kv,
             p.stages, *p.grid, p.smem_bytes, _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"flash_attn_fwd: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of csrc/flash_attention.cu")
    ap.add_argument("--splits", default="1,2,4,8,16",
                    help="key splits (CTAs a cluster) to time beside the "
                    "plan's")
    ap.add_argument("--phases", action="store_true",
                    help="also time the cut copies (PHASES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_decode_bench: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    sources = args.source or [_build.CSRC / "flash_attention.cu"]
    jobs = [(f"v{i}", s, None) for i, s in enumerate(sources)]
    if args.phases:
        jobs += [(f"v{i}_{ph}", s, ph) for i, s in enumerate(sources)
                 for ph in PHASES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        fns = dict(zip((j[0] for j in jobs),
                       ex.map(lambda j: build(*j), jobs)))
    splits = [int(x) for x in args.splits.split(",") if x]
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
    for B, Skv, H, KV, hd in SHAPES:
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(bf16)
        k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(bf16)
        v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(bf16)
        o, lse = torch.empty_like(q), torch.empty(B, H, 1, device="cuda")
        kv = torch.cat([k, v])
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        p0 = plan(bf16, hd, B, 1, H, _build.sm_count(0), Skv=Skv, KV=KV)
        want = flash_attention_ref(q, k, v, causal=False)
        for name, fn in fns.items():
            if "_" not in name:
                launch(fn, q, k, v, o, lse, p0)
                ok, err = close_enough(o, want, TOL[bf16]["flash_attention"],
                                       bf16)
                print(json.dumps({"shape": [B, 1, Skv, H, KV, hd],
                                  "version": name, "ok": ok,
                                  "max_abs_err": err}), flush=True)
        timed = {"wgmma": lambda: flash_attention_cuda(
                     q, k, v, causal=False, variant="wgmma"),
                 "sdpa": lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, enable_gqa=True),
                 "read_floor": lambda: kv.sum(dtype=torch.float32),
                 "launch_floor": lambda: torch.cuda._sleep(0)}
        for name, fn in fns.items():
            for n in [p0.grid[0]] + [n for n in splits if n != p0.grid[0]]:
                p = dataclasses.replace(p0, grid=(n, *p0.grid[1:]))
                timed[f"{name}/splits{n}"] = (
                    lambda fn=fn, p=p: launch(fn, q, k, v, o, lse, p))
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        order = list(timed)
        for rnd, names in enumerate((order, order[::-1])):
            for name in names:
                ms = time_ms(timed[name], flush)
                print(json.dumps({"shape": [B, 1, Skv, H, KV, hd],
                                  "round": rnd, "what": name, "ms": ms,
                                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                                  "plan_splits": p0.grid[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
