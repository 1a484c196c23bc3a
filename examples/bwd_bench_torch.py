#!/usr/bin/env python3
"""Time the port's backward kernels beside an earlier version of them,
and beside their PyTorch yardsticks, on one GPU.

    python3 examples/bwd_bench_torch.py --old DIR [--kernels flash,rmsnorm,ssd]

``DIR`` is the ``csrc/`` of an earlier checkout, e.g. the parent commit's,
unpacked with

    git archive HEAD~1 src/repro_torch/csrc | tar -x -C build/parent

It is built by ``_build.build(DIR)`` beside the repo's own library.
``--kernels`` picks the backwards to time (all three by default):

- ``flash`` and ``rmsnorm`` need an old ``flash_attn_bwd`` and
  ``rmsnorm_bwd`` with the first backwards' C interface (the ``mma_sync``
  flash backward over 64-key CTAs with a caller-zeroed f32 dQ buffer; the
  RMSNorm backward with per-CTA dw rows).  At the qwen3-1.7b and
  zamba2-1.2b training shapes (flash attention, bf16, causal) and at the
  qwen3 RMSNorm shapes ((4096, 2048) and (65536, 128), bf16), in turns:
  old, new, library, then library, new, old.  Each version is timed
  through its whole wrapper (allocations, the D pass, the dQ cast).
- ``ssd``: the old library's ``ssd_chunk_bwd`` (the repo's C signature;
  the f32 FMA kernel groups 4 heads, so its workspace is sized for that)
  beside ``ssd_chunk_bwd_cuda`` at zamba2-1.2b's and mamba2-370m's train
  shapes (b4 c4 l256 p64, h64 n64 and h32 n128, f32, on ``chip_smoke.py``'s
  inputs), in two rounds, the second in reverse order.  No PyTorch call
  computes it.

Each version is held against the plain backward (``chip_smoke.py``'s
gradient tolerance) and timed as ``chip_smoke.py`` times a kernel (cold L2,
median of 20).  Prints the card's name and power limit, then one JSON line
per (shape, version, turn), and one traced call of each new wrapper
(``chip_smoke.py``'s ``profile`` line: device time by kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import (grad_close, profile_once, rel_l2, ssd_inputs,  # noqa: E402
                        time_ms)
from repro_torch.kernels import _build  # noqa: E402

FLASH_SHAPES = [(4, 1024, 1024, 16, 8, 128), (4, 1024, 1024, 32, 32, 64)]
RMS_SHAPES = [(4096, 2048), (65536, 128)]
SSD_SHAPES = [(4, 4, 256, 64, 64, 64), (4, 4, 256, 32, 64, 128)]
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {
    "flash": {"flash_attn_bwd": ([_P] * 10 + [_I] * 9 + [_F] + [_I] * 7
                                 + [_P], _I)},
    "rmsnorm": {"rmsnorm_bwd": _build.SIGNATURES["rmsnorm_bwd"]},
    "ssd": {"ssd_chunk_bwd": _build.SIGNATURES["ssd_chunk_bwd"]},
}


def load_old(csrc: Path, kinds) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build(csrc)))
    for kind in kinds:
        for name, (argtypes, restype) in OLD_SIGNATURES[kind].items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def old_flash_bwd(lib, q, k, v, o, lse, do, scale):
    """PR 15's wrapper: mma_sync, 64 keys a CTA, 32 q rows at hd 128."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    bq = 32 if hd == 128 else 64
    smem = 2 * ((2 * 64 + 2 * bq) * (hd + 8) + bq * 72) + 8 * bq
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = lib.flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Sq, Skv, H, KV, hd, _build.DTYPE_CODES[q.dtype], 1,
        0, scale, 1, bq, 128, -(-Skv // 64), KV, B, smem,
        _build.stream_ptr(q))
    if err:
        raise RuntimeError(f"old flash_attn_bwd: CUDA error {err}")
    return dq.to(q.dtype), dk, dv


def old_rmsnorm_bwd(lib, x, w, dy, sms):
    """PR 15's wrapper: 8-32 lanes a row, at most two CTAs an SM, a row of
    dw partials per CTA summed by a second kernel."""
    rows, d = x.shape
    nvec = d * x.element_size() // 16
    lanes = 8 if nvec <= 8 else (16 if nvec <= 16 else 32)
    parts = max(1, min(-(-rows // (8 * (32 // lanes))), 2 * sms))
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    part = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(),
                          dx.data_ptr(), dw.data_ptr(), part.data_ptr(), parts,
                          rows, d, 1e-5, _build.DTYPE_CODES[x.dtype],
                          _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"old rmsnorm_bwd: CUDA error {err}")
    return dx, dw


def old_ssd_bwd(lib, x, a, B, C, dy, ds):
    """The f32 FMA kernel's wrapper: groups of 4 heads, so its workspace
    holds 4-head group partials (dG tiles, dB's state part) and the dcum
    rows."""
    b, c, l, h, p = x.shape
    n = B.shape[-1]
    bc, tiles, groups = b * c, -(-l // 64), -(-h // 4)
    ws_floats = (bc * groups * tiles * (tiles + 1) // 2 * 64 * 64
                 + bc * groups * l * n + bc * h * tiles * l)
    grads = tuple(torch.empty_like(t) for t in (x, a, B, C))
    ws = torch.empty(ws_floats, dtype=torch.float32, device=x.device)
    err = lib.ssd_chunk_bwd(*(t.data_ptr() for t in (x, a, B, C, dy, ds)
                              + grads), ws.data_ptr(), ws_floats, bc, l, h,
                            p, n, _build.stream_ptr(x))
    if err:
        raise RuntimeError(f"old ssd_chunk_bwd: CUDA error {err}")
    return grads


def report(kernel, shape, version, turn, got, want, kind, ms,
           dtype=torch.bfloat16) -> bool:
    """One JSON line; True if every leaf holds (library rows: not checked)."""
    line = {"kernel": kernel, "shape": list(shape), "version": version,
            "turn": turn, "ms": ms}
    ok = True
    if got is not None:
        oks, errs = zip(*(grad_close(g, w, dtype, kind)
                          for g, w in zip(got, want)))
        ok = all(oks)
        line.update(ok=ok, max_abs_err=max(errs),
                    rel_l2=[rel_l2(g, w) for g, w in zip(got, want)])
    print(json.dumps(line), flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, required=True,
                    help="csrc/ of an earlier checkout")
    ap.add_argument("--kernels", default="flash,rmsnorm,ssd",
                    help="comma-separated: flash, rmsnorm, ssd")
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if not set(kinds) <= set(OLD_SIGNATURES):
        ap.error(f"--kernels: {kinds} not within {sorted(OLD_SIGNATURES)}")
    if not torch.cuda.is_available():
        print("bwd_bench: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_bwd_ref
    from repro_torch.kernels.ssd import ssd_chunk_bwd_cuda, ssd_chunk_bwd_ref
    old = load_old(args.old.resolve(), kinds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    bf16 = torch.bfloat16
    ok = True

    for shape in FLASH_SHAPES if "flash" in kinds else []:
        B, Sq, Skv, H, KV, hd = shape
        q, do = (torch.randn(B, Sq, H, hd, generator=gen, device="cuda")
                 .to(bf16) for _ in range(2))
        k, v = (torch.randn(B, Skv, KV, hd, generator=gen, device="cuda")
                .to(bf16) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        scale = 1.0 / math.sqrt(hd)
        fns = {
            "old": lambda: old_flash_bwd(old, q, k, v, o, lse, do, scale),
            "new": lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do),
            "library": lambda: torch.autograd.grad(out, (qt, kt, vt),
                                                   do.transpose(1, 2),
                                                   retain_graph=True)}
        for turn, order in enumerate((list(fns), list(fns)[::-1])):
            for name in order:
                got = fns[name]() if name != "library" else None
                ok &= report("flash_attention_bwd", shape, name, turn, got,
                             want, "flash_attention_bwd",
                             time_ms(fns[name], flush))
        # Device time by kernel of one call (the D pass, the main kernel,
        # the allocations and the dQ cast).
        profile_once(str(shape), "flash_attention_bwd", fns["new"])
        del want, out

    for rows, d in RMS_SHAPES if "rmsnorm" in kinds else []:
        x, dy = (torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
                 for _ in range(2))
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(bf16)
        want = rmsnorm_bwd_ref(x, w, dy)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.rms_norm(xg, (d,), wg, 1e-5)
        fns = {"old": lambda: old_rmsnorm_bwd(old, x, w, dy, sms),
               "new": lambda: rmsnorm_bwd_cuda(x, w, dy),
               "library": lambda: torch.autograd.grad(y, (xg, wg), dy,
                                                      retain_graph=True)}
        for turn, order in enumerate((list(fns), list(fns)[::-1])):
            for name in order:
                got = fns[name]() if name != "library" else None
                # dx at the gradient tolerance; dw (a sum over every row)
                # by its relative L2 error, as chip_smoke.py holds it.
                good = report("rmsnorm_bwd", (rows, d), name, turn,
                              got[:1] if got else None, want[:1],
                              "rmsnorm_bwd", time_ms(fns[name], flush))
                if got:
                    good &= rel_l2(got[1], want[1]) <= 2e-2
                ok &= good
        profile_once(str((rows, d)), "rmsnorm_bwd", fns["new"])

    for shape in SSD_SHAPES if "ssd" in kinds else []:
        b, c, l, h, p, n = shape
        torch.backends.cuda.matmul.allow_tf32 = False
        x, a, B, C = ssd_inputs((b, c, l, h, p), (b, c, l, h), (b, c, l, n),
                                n ** -0.5, gen)
        dy = torch.randn(b, c, l, h, p, generator=gen, device="cuda")
        ds = torch.randn(b, c, h, p, n, generator=gen, device="cuda")
        args_ = (x, a, B, C, dy, ds)
        want = ssd_chunk_bwd_ref(*args_)
        fns = {"old": lambda: old_ssd_bwd(old, *args_),
               "new": lambda: ssd_chunk_bwd_cuda(*args_)}
        for turn, order in enumerate((list(fns), list(fns)[::-1])):
            for name in order:
                ok &= report("ssd_chunk_bwd", shape, name, turn, fns[name](),
                             want, "ssd_chunk_bwd", time_ms(fns[name], flush),
                             torch.float32)
        profile_once(str(shape), "ssd_chunk_bwd", fns["new"])
        del want
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
