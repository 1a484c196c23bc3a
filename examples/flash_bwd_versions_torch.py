#!/usr/bin/env python3
"""The bf16 flash backward of this checkout beside an earlier version of
it with the same C interface, on one GPU: each version's gradients held
against the plain backward at ``chip_smoke.py``'s tolerance over several
input draws, and both timed in turns (old, new, new, old).

    python3 examples/flash_bwd_versions_torch.py --old DIR [--draws 6]

``DIR`` is the ``csrc/`` of the earlier checkout, e.g. the parent commit's,

    git archive HEAD~1 src/repro_torch/csrc | tar -x -C build/parent

built by ``_build.build(DIR)`` beside this checkout's library; both run
through this checkout's wrapper (``flash_attention_bwd_cuda``: its plan,
the D pass, the dQ cast), whose shared memory is at least what either
kernel needs.  Shapes (causal, bf16): qwen3-1.7b's and qwen2.5-14b's
train shapes, llama3-405b's GQA group 16 (H 128, KV 8) at one sequence of
1024, and zamba2-1.2b's (hd 64) as a control.  Each draw of inputs is
drawn from its own seed, as ``chip_smoke.py`` draws a kernel case (randn
on the card, cast to bf16).  Prints the card's name and power limit, one
JSON line a (shape, version, draw) with its worst error and whether it
held (each of dq, dk, dv), and one a (shape, version, turn) with its time
(cold L2, median of 20).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import grad_close, rel_l2, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SHAPES = [(4, 1024, 1024, 16, 8, 128), (4, 1024, 1024, 40, 8, 128),
          (1, 1024, 1024, 128, 8, 128), (4, 1024, 1024, 32, 32, 64)]


def load_lib(csrc: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(csrc)))
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def with_lib(lib, fn):
    """``fn()`` with ``_build.load`` handing out ``lib``."""
    saved = _build.load
    _build.load = lambda: lib
    try:
        return fn()
    finally:
        _build.load = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True,
                    help="csrc/ of an earlier checkout")
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_versions: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain version's
    libs = {"old": load_lib(args.old.resolve()), "new": _build.load()}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
    for shape in SHAPES:
        B, Sq, Skv, H, KV, hd = shape
        for draw in range(args.draws):
            gen = torch.Generator(device="cuda").manual_seed(draw)
            q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(bf16)
            k, v = (torch.randn(B, Skv, KV, hd, generator=gen, device="cuda")
                    .to(bf16) for _ in range(2))
            do = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(bf16)
            o, lse = flash_attention_cuda(q, k, v, return_lse=True)
            want = flash_attention_bwd_ref(q, k, v, o, lse, do)
            for name, lib in libs.items():
                got = with_lib(lib, lambda: flash_attention_bwd_cuda(
                    q, k, v, o, lse, do))
                oks, errs = zip(*(grad_close(g, w, bf16, "flash_attention_bwd")
                                  for g, w in zip(got, want)))
                print(json.dumps({
                    "shape": list(shape), "version": name, "draw": draw,
                    "ok": all(oks), "ok_dq_dk_dv": list(oks),
                    "max_abs_err_dq_dk_dv": list(errs),
                    "rel_l2_dq_dk_dv": [rel_l2(g, w)
                                        for g, w in zip(got, want)]}),
                      flush=True)
                del got
            del want
        for turn, name in enumerate(("old", "new", "new", "old")):
            ms = time_ms(lambda: with_lib(libs[name], lambda: (
                flash_attention_bwd_cuda(q, k, v, o, lse, do))), flush)
            print(json.dumps({"shape": list(shape), "version": name,
                              "turn": turn, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
