#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase (the main path)
    python3 chip_smoke.py --kernels-only  # phases 1-3 only: build and check
                                          # the kernels, then stop
    python3 chip_smoke.py --profile-only  # phases 1, 2 and 6 only

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   — the card's name, power limit and compute capability (the raw
                ``nvidia-smi --query-gpu=name,power.limit`` line is printed
                too); fails without CUDA.
  2. build    — the kernels' shared library from ``src/repro_torch/csrc``.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the serving paths' shapes (RMSNorm and flash
                attention in bf16 and f32, the SSD chunk kernel in f32; TF32
                off), with kernel / plain / library times (median of cold-L2
                runs); and ``ssd`` (chunk kernel + recurrence) against
                ``ssd_ref`` at the zamba2 prefill shape.
  4. prefill  — per model: a reduced model on the card against the CPU (f32
                weights), then ``make_prefill`` at full width (random weights,
                seed 0, bf16) on 4 x 1024 tokens, launches per forward
                checked, logits held against the plain-kernel forward on the
                same weights in bf16 and cast to f32 (``kernels_vs_plain``).
  5. serve    — qwen3-1.7b and zamba2-1.2b: ``ServingEngine(batch=4,
                max_seq=512)`` answers 8 requests; one decode step with
                kernels against one with plain versions (mamba2-370m: the
                same comparison after a few decode steps).
  6. profile  — one traced prefill and decode step of each model: device
                time by kernel (and summed for each of the port's kernels)
                and the device's busy share (not part of the main path).
                ``--profile-only`` runs this phase alone; copied into an
                older checkout, it profiles that checkout's package.
  7. the ``{"kernels": [...]}`` line: launches on the main path (each
     model's prefill and serving, counted from 0 per model and summed;
     flash attention's also by variant, and every prefill flash launch
     must be the ``wgmma`` one), errors, times and bounds.

The models, in order: qwen3-1.7b (dense; RMSNorm and flash attention),
zamba2-1.2b (hybrid; all three kernels), mamba2-370m (ssm; RMSNorm and the
SSD chunk kernel, prefill only on the main path).

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the script exits non-zero without it.  Retrieval is off: the port has no
cache engine of its own yet.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCHS = ("qwen3-1.7b", "zamba2-1.2b", "mamba2-370m")
SERVED = ("qwen3-1.7b", "zamba2-1.2b")          # main path: prefill + serve
PROFILED = ARCHS
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12}              # f32 outside tensor cores
PEAK_TF32 = 495e12                               # dense tensor-core TF32
BF16_ULP = 2.0 ** -7                             # relative spacing of bf16
# Kernel tolerances, as in tests/test_kernels.py.
TOL = {torch.bfloat16: {"rmsnorm": 3e-2, "flash_attention": 2e-2},
       torch.float32: {"rmsnorm": 1e-5, "flash_attention": 5e-5,
                       "ssd_chunk": 1e-4, "ssd": 1e-4}}
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.05            # tests/test_models.py
SMALL_F32_TOL = 1e-4                             # card vs CPU, f32 weights
SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:24"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:72"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd/kernel.py:44"),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def close_enough(got, want, atol: float, dtype) -> tuple:
    """(ok, max_abs_err).  bf16 also allows one bf16 ulp of |want|: the kernel
    and the plain version sum in different orders, so a value next to a
    rounding tie may land one ulp apart, and above |x| = 4 one ulp exceeds
    the bf16 atol."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rtol = BF16_ULP if dtype == torch.bfloat16 else 0.0
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= atol + rtol * want.abs()).all())
    return ok, float(err.max())


def time_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each after a write
    of ``flush`` (larger than the 50 MB L2) so inputs come from HBM."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# --------------------------------------------------------------- phase 1

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "power_limit": smi.split(",")[-1].strip(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit("device", **info)
    return info


# --------------------------------------------------------------- phase 2

def ptxas_by_kernel(log: str) -> dict:
    """Registers, spill bytes and static shared memory of each compiled
    entry function, from ``-Xptxas -v`` output (mangled names)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name and "Used" in ln and "registers" in ln:
            out[name]["regs"] = int(re.search(r"Used (\d+) registers",
                                              ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def phase_build() -> dict:
    """Builds and loads the kernels; returns ``ptxas_by_kernel`` of the
    build log."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log").read_text()
    ptxas = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
             if "registers" in ln]
    emit("build", seconds=seconds, library=str(so.relative_to(ROOT)),
         ptxas=ptxas)
    return ptxas_by_kernel(log)


def ssd_build(build: dict, p: int, n: int) -> dict:
    """ptxas's numbers for ``ssd_chunk_kernel<p, n>``."""
    for name, info in build.items():
        if "ssd_chunk_kernel" in name and f"ILi{p}ELi{n}E" in name:
            return info
    return {}


# --------------------------------------------------------------- phase 3

def rmsnorm_case(rows, d, dtype, gen, flush, timed):
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_ref
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    ok, err = close_enough(rmsnorm_cuda(x, w), rmsnorm_ref(x, w),
                           TOL[dtype]["rmsnorm"], dtype)
    r = {"kernel": "rmsnorm", "shape": [rows, d], "dtype": str(dtype)[6:],
         "ok": ok, "max_abs_err": err, "tol": TOL[dtype]["rmsnorm"]}
    if timed:
        nbytes = (2 * rows * d + d) * x.element_size()
        r.update(ms=time_ms(lambda: rmsnorm_cuda(x, w), flush),
                 plain_ms=time_ms(lambda: rmsnorm_ref(x, w), flush),
                 library_ms=time_ms(lambda: F.rms_norm(x, (d,), w, 1e-5),
                                    flush),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return r


def attention_work(B, Sq, Skv, H, hd, causal, q_offset):
    """FLOPs of the two products over the (q, k) pairs the mask keeps."""
    if causal:
        pairs = sum(min(Skv, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    return 4 * B * H * hd * pairs


def flash_case(B, Sq, Skv, H, KV, hd, causal, q_offset, dtype, gen, flush,
               timed):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_ref)
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    ok, err = close_enough(flash_attention_cuda(q, k, v, **kw),
                           flash_attention_ref(q, k, v, **kw),
                           TOL[dtype]["flash_attention"], dtype)
    from repro_torch.kernels.flash_attention.kernel import plan
    r = {"kernel": "flash_attention", "shape": [B, Sq, Skv, H, KV, hd],
         "variant": plan(dtype, hd, B, Sq, H).variant,
         "causal": causal, "q_offset": q_offset, "dtype": str(dtype)[6:],
         "ok": ok, "max_abs_err": err, "tol": TOL[dtype]["flash_attention"]}
    if timed:
        flops = attention_work(B, Sq, Skv, H, hd, causal, q_offset)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        r.update(ms=time_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                            flush),
                 plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                  flush, iters=5),
                 library_ms=(time_ms(sdpa, flush)
                             if causal and q_offset == 0 and Sq == Skv
                             else None),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        r["tflops"] = flops / r["ms"] / 1e9
    return r


def ssd_work(b, c, l, h, p, n):
    """(FLOPs, bytes) of the SSD chunk block.  FLOPs over the P = l(l+1)/2
    (i, j) pairs the mask keeps: C Bᵀ once per (b, c), since it does not
    depend on the head (2 n P), then per (b, c, h) the masked product with
    x (2 p P) and the end state (2 l n p).  Bytes: x, a, B, C read once;
    y and the states written once, f32.  A 3xTF32 design does three
    tensor-core products for each of these FLOPs."""
    pairs = l * (l + 1) // 2
    flops = b * c * (2 * n * pairs + h * (2 * p * pairs + 2 * l * n * p))
    nbytes = 4 * b * c * (2 * l * h * p + h * p * n + l * h + 2 * l * n)
    return flops, nbytes


def ssd_inputs(shape_x, shape_a, shape_bc, scale_bc, gen):
    """tests/test_kernels.py's inputs: x * 0.5, a = -|N| * 0.1, B and C
    scaled by ``scale_bc`` (1/sqrt(n) at the model's shapes)."""
    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    return (rand(shape_x) * 0.5, -rand(shape_a).abs() * 0.1,
            rand(shape_bc) * scale_bc, rand(shape_bc) * scale_bc)


def ssd_chunk_case(b, c, l, h, p, n, scale_bc, gen, flush, timed, build):
    from repro_torch.kernels.ssd import ssd_chunk_cuda, ssd_chunk_ref
    from repro_torch.kernels.ssd.kernel import plan
    x, a, B, C = ssd_inputs((b, c, l, h, p), (b, c, l, h), (b, c, l, n),
                            scale_bc, gen)
    tol = TOL[torch.float32]["ssd_chunk"]
    got, want = ssd_chunk_cuda(x, a, B, C), ssd_chunk_ref(x, a, B, C)
    oks, errs = zip(*(close_enough(g, w, tol, torch.float32)
                      for g, w in zip(got, want)))
    from repro_torch.kernels import _build
    pl, ptxas = plan(b, c, l, h, p, n), ssd_build(build, p, n)
    # The kernel's own dynamic shared memory; plan() only mirrors it.
    smem = _build.load().ssd_chunk_smem_bytes(l, p, n)
    r = {"kernel": "ssd_chunk", "shape": [b, c, l, h, p, n],
         "dtype": "float32", "ok": all(oks) and smem == pl.smem_bytes,
         "max_abs_err": max(errs), "max_abs_err_states": errs[1], "tol": tol,
         "blocks": pl.blocks, "head_group": pl.head_group,
         "regs": ptxas.get("regs"), "spill_bytes": ptxas.get("spill_bytes"),
         "smem": smem + ptxas.get("static_smem", 0),
         "smem_plan_matches": smem == pl.smem_bytes}
    if timed:
        flops, nbytes = ssd_work(b, c, l, h, p, n)
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        r.update(ms=time_ms(lambda: ssd_chunk_cuda(x, a, B, C), flush),
                 plain_ms=time_ms(lambda: ssd_chunk_ref(x, a, B, C), flush,
                                  iters=5),
                 library_ms=None,      # no single PyTorch call computes it
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 # The floor of a 3xTF32 tensor-core design.
                 bound_tc_ms=max(3 * flops / PEAK_TF32 * 1e3, t_bytes))
        r["tflops"] = flops / r["ms"] / 1e9
    return r


def ssd_ops_case(b, s, h, p, n, chunk, gen):
    """``ssd`` on the card (chunk kernel + recurrence across chunks) against
    ``ssd_ref`` on the same inputs."""
    from repro_torch.kernels.ssd import ssd
    x, a, B, C = ssd_inputs((b, s, h, p), (b, s, h), (b, s, n), n ** -0.5,
                            gen)
    tol = TOL[torch.float32]["ssd"]
    got = ssd(x, a, B, C, chunk=chunk)
    want = ssd(x, a, B, C, chunk=chunk, force_ref=True)
    oks, errs = zip(*(close_enough(g, w, tol, torch.float32)
                      for g, w in zip(got, want)))
    return {"kernel": "ssd", "shape": [b, s, h, p, n], "chunk": chunk,
            "dtype": "float32", "ok": all(oks), "max_abs_err": max(errs),
            "max_abs_err_final_state": errs[1], "tol": tol}


def phase_kernels(build: dict) -> list:
    """Every case must pass; returns the cases, each kernel's main-path
    shape first.  ``build``: ``phase_build``'s ptxas numbers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    # (rows, d): attn/ffn/final norm over B*S = 4096 rows (qwen3, zamba2),
    # q_norm over B*S*16 rows, k_norm over B*S*8 rows, decode's 4 rows,
    # mamba2's layer norm, a ragged count, and llama3-405b's d_model.
    for rows, d, timed in [(4096, 2048, True), (65536, 128, True),
                           (32768, 128, True), (4, 2048, True),
                           (4096, 1024, True), (1000, 2048, False),
                           (64, 16384, False)]:
        for dtype in (torch.bfloat16, torch.float32):
            results.append(rmsnorm_case(rows, d, dtype, gen, flush,
                                        timed and dtype == torch.bfloat16))
    bf16, f32 = torch.bfloat16, torch.float32
    for shape, causal, off, timed in [
            ((4, 1024, 1024, 16, 8, 128), True, 0, (bf16, f32)),  # qwen3
            ((4, 1024, 1024, 32, 32, 64), True, 0, (bf16,)),  # zamba2 shared
            ((2, 256, 1024, 16, 8, 128), True, 768, ()),      # q_offset
            ((2, 128, 1601, 16, 8, 128), False, 0, ()),       # 1601 image kv
            ((2, 512, 512, 8, 2, 64), True, 0, ()),           # hd 64
            ((1, 1000, 1000, 16, 8, 128), True, 0, ()),       # ragged Sq
            ((1, 130, 130, 4, 4, 32), True, 0, ()),           # hd 32
            ((2, 16, 16, 4, 2, 16), True, 0, ())]:            # hd 16
        for dtype in (bf16, f32):
            results.append(flash_case(*shape, causal, off, dtype, gen, flush,
                                      dtype in timed))
    # (b, c, l, h, p, n, B/C scale): zamba2 and mamba2 prefill (4 x 1024
    # tokens), the reduced configs, tests/test_kernels.py's shape, a chunk
    # that is not a multiple of the 64-row tile, and ragged head groups (5
    # heads in one group; 9 in groups of 5 and 4).
    for *shape, scale, timed in [(4, 4, 256, 64, 64, 64, 64 ** -0.5, True),
                                 (4, 4, 256, 32, 64, 128, 128 ** -0.5, True),
                                 (2, 2, 32, 8, 16, 16, 1.0, False),
                                 (1, 4, 16, 2, 16, 8, 1.0, False),
                                 (1, 3, 48, 3, 16, 16, 1.0, False),
                                 (1, 2, 200, 5, 64, 64, 64 ** -0.5, False),
                                 (2, 1, 256, 9, 64, 128, 128 ** -0.5, False)]:
        results.append(ssd_chunk_case(*shape, scale, gen, flush, timed,
                                      build))
    results.append(ssd_ops_case(4, 1024, 64, 64, 64, 256, gen))
    for r in results:
        emit("kernels", **r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    return results


# --------------------------------------------------------------- phase 4

def counts() -> dict:
    """Launches so far: each kernel's, and flash attention's by variant
    (``flash_attention/wgmma`` and so on)."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd import ssd_chunk_cuda
    return {"rmsnorm": rmsnorm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches,
            "ssd_chunk": ssd_chunk_cuda.launches,
            **{f"flash_attention/{k}": n for k, n
               in flash_attention_cuda.variant_launches.items()}}


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd import ssd_chunk_cuda
    rmsnorm_cuda.launches = 0
    flash_attention_cuda.launches = 0
    flash_attention_cuda.variant_launches = dict.fromkeys(
        flash_attention_cuda.variant_launches, 0)
    ssd_chunk_cuda.launches = 0


def tree_to(params, fn):
    """Apply ``fn`` to every tensor of a parameter tree (one level of
    sub-dicts: ``blocks``, ``shared``)."""
    return {k: ({n: fn(t) for n, t in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in params.items()}


def small_model_check(arch: str) -> None:
    """A reduced model with f32 weights: the card (kernels) against the CPU
    (plain versions) on the same weights and tokens; 40 tokens span two of
    the reduced SSM configs' 32-token chunks."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import forward, init_params
    cfg = reduced_config(arch)
    cpu = tree_to(init_params(cfg, torch.Generator().manual_seed(0)),
                  lambda t: t.float())
    gpu = tree_to(cpu, lambda t: t.cuda())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    with torch.inference_mode():
        want, _ = forward(cpu, cfg, toks, remat="none")
        got, _ = forward(gpu, cfg, toks.cuda(), remat="none")
    err = float((got.cpu() - want).abs().max())
    ok = bool(torch.allclose(got.cpu(), want, atol=SMALL_F32_TOL,
                             rtol=SMALL_F32_TOL))
    emit("prefill", arch=arch, check="reduced model, card vs CPU (f32)",
         ok=ok, max_abs_err=err, tol=SMALL_F32_TOL)
    if not ok:
        raise AssertionError(f"reduced {arch} on the card differs from the "
                             f"CPU by {err}")


def expected_per_forward(cfg) -> dict:
    """Kernel launches one prefill forward must make; every flash launch is
    the wgmma variant (bf16, hd 64 / 128)."""
    L = cfg.n_layers
    if cfg.family == "dense":
        norms, flash, ssd = L * (2 + 2 * cfg.qk_norm) + 1, L, 0
    else:
        flash = -(-L // cfg.shared_attn_every) if cfg.family == "hybrid" else 0
        norms, ssd = L + 2 * flash + 1, L
    return {"rmsnorm": norms, "flash_attention": flash, "ssd_chunk": ssd,
            "flash_attention/wgmma": flash, "flash_attention/mma_sync": 0,
            "flash_attention/fma": 0}


def phase_prefill(cfg, params) -> dict:
    from repro_torch.serve.serve_step import make_prefill
    B, S, runs = 4, 1024, 3
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    prefill = make_prefill(cfg, "cuda")
    before = counts()
    logits = prefill(params, tokens)                      # warm-up run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        prefill(params, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / runs * 1e3
    per_forward = {k: (v - before[k]) / (runs + 1)
                   for k, v in counts().items()}
    if tuple(logits.shape) != (B, S, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    if per_forward != expected_per_forward(cfg):
        raise AssertionError(f"{cfg.name} prefill launched {per_forward}, "
                             f"expected {expected_per_forward(cfg)}")
    return {"logits": logits, "tokens": tokens, "ms": ms,
            "tokens_per_s": B * S / ms * 1e3, "launches": per_forward,
            "batch": B, "seq": S}


def held(got, want) -> tuple:
    """(within LOGITS_ATOL / LOGITS_RTOL, max abs error) of two logits."""
    got, want = got.float(), want.float()
    return (bool(torch.allclose(got, want, atol=LOGITS_ATOL,
                                rtol=LOGITS_RTOL)),
            float((got - want).abs().max()))


def kernels_vs_plain(cfg, params, run) -> dict:
    """``run(params, force_ref)`` -> logits, with kernels against plain
    versions: on the bf16 weights, and on the same weights cast to f32.

    Both must hold for the dense family.  For ssm/hybrid only the f32 pair
    must: with random bf16 weights the 38-48 Mamba2 layers amplify a
    last-bit change of the SSD chunk's f32 sums (its order differs between
    the kernel and the einsums) into logit differences of order 1, which no
    right kernel can avoid (tests/test_torch_ssm.py pins this on the CPU
    with no kernel at all); in f32 the same change stays near 1e-3."""
    bf16_ok, bf16_err = held(run(params, False), run(params, True))
    p32 = tree_to(params, lambda t: t.float())
    f32_ok, f32_err = held(run(p32, False), run(p32, True))
    del p32
    return {"ok": f32_ok and (bf16_ok or cfg.family != "dense"),
            "max_abs_err": bf16_err, "bf16_ok": bf16_ok,
            "max_abs_err_f32": f32_err, "f32_ok": f32_ok}


def check_prefill(cfg, params, pre) -> None:
    from repro_torch.serve.serve_step import make_prefill

    def run(p, force_ref):
        if p is params and not force_ref:
            return pre["logits"]                 # the main path's own run
        return make_prefill(cfg, "cuda", force_ref=force_ref)(
            p, pre["tokens"])
    cmp = kernels_vs_plain(cfg, params, run)
    emit("prefill", arch=cfg.name, batch=pre["batch"], seq=pre["seq"],
         ms=pre["ms"], tokens_per_s=pre["tokens_per_s"],
         launches_per_forward=pre["launches"], **cmp,
         logits_max_abs=float(pre["logits"].float().abs().max()),
         tol={"atol": LOGITS_ATOL, "rtol": LOGITS_RTOL},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not cmp["ok"]:
        raise AssertionError(f"{cfg.name} prefill logits with kernels differ "
                             "from the plain-kernel forward")


# --------------------------------------------------------------- phase 5

def phase_serve(cfg, params) -> dict:
    from repro_torch.serve.engine import Request, ServingEngine
    n_req, max_new = 8, 16
    eng = ServingEngine(params, cfg, batch=4, max_seq=512, device="cuda")
    rng = np.random.default_rng(0)
    for rid in range(n_req):
        prompt = rng.integers(0, cfg.vocab, rng.integers(16, 65))
        eng.submit(Request(rid, prompt, max_new=max_new))
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in counts().items()}
    ok = (len(done) == n_req
          and all(len(r.output) == max_new for r in done))
    return {"engine": eng, "ok": ok, "requests": len(done),
            "tokens": sum(len(r.output) for r in done), "seconds": dt,
            "steps": eng.steps, "launches": launches}


def clone_state(state) -> dict:
    """A copy of every tensor of a decode state (decode_step updates them in
    place)."""
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in state.items()}


def decode_step_check(cfg, params, state) -> dict:
    """One decode step with kernels against one with plain versions, each on
    its own copy of ``state`` (see ``kernels_vs_plain``); raises beyond the
    logits tolerance."""
    from repro_torch.serve.serve_step import make_serve_step
    batch = state["ssd" if "ssd" in state else "k"].shape[1]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (batch, 1)))

    def run(p, force_ref):
        return make_serve_step(cfg, "cuda", force_ref=force_ref)(
            p, clone_state(state), toks)[0]
    cmp = kernels_vs_plain(cfg, params, run)
    if not cmp["ok"]:
        raise AssertionError(f"{cfg.name} decode logits with kernels differ "
                             f"from plain versions: {cmp}")
    return {f"decode_{k}": v for k, v in cmp.items() if k != "ok"}


def check_serve(cfg, params, srv) -> None:
    eng = srv["engine"]
    state_mb = sum(v.numel() * v.element_size()
                   for v in eng.state.values() if torch.is_tensor(v)) / 1e6
    cmp = decode_step_check(cfg, params, eng.state)
    per_step = {k: v / max(1, srv["steps"]) for k, v in srv["launches"].items()}
    emit("serve", arch=cfg.name, ok=srv["ok"], requests=srv["requests"],
         tokens=srv["tokens"], steps=srv["steps"], seconds=srv["seconds"],
         tokens_per_s=srv["tokens"] / srv["seconds"],
         ms_per_decode_step=srv["seconds"] / max(1, srv["steps"]) * 1e3,
         launches_per_decode_step=per_step, decode_state_mb=state_mb,
         **cmp, retrieval="off")
    if not srv["ok"]:
        raise AssertionError(f"{cfg.name} serving left requests unfinished")


def check_decode(cfg, params, steps: int = 8) -> None:
    """For a model that is not served on the main path: ``steps`` decode
    steps from an empty state, then one step with kernels against one with
    plain versions."""
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.serve_step import make_serve_step
    state = init_decode_state(cfg, 4, 64, device="cuda")
    step = make_serve_step(cfg, "cuda")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, steps))
    for t in range(steps):
        _, state = step(params, state, toks[:, t:t + 1])
    cmp = decode_step_check(cfg, params, state)
    emit("serve", arch=cfg.name, check="decode step after "
         f"{steps} steps, kernels vs plain", ok=True, **cmp)


# --------------------------------------------------------------- phase 7

def phase_profile(cfg, params) -> None:
    """Where the time goes: one traced prefill and one traced decode step
    (torch.profiler), device time by kernel and the device's busy share of
    the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                           device="cuda")
    state = init_decode_state(cfg, 4, 512, device="cuda")
    step_toks = tokens[:, :1]
    prefill, step = make_prefill(cfg, "cuda"), make_serve_step(cfg, "cuda")
    for what, fn in (("prefill", lambda: prefill(params, tokens)),
                     ("decode_step", lambda: step(params, state, step_toks))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_ms = sum(r[1] for r in rows)
        top = sorted(rows, key=lambda r: -r[1])[:10]
        # "ssd_" also catches an older checkout's two SSD kernels.
        ours = {k: [sum(ms for name, ms, _ in rows if k in name),
                    sum(n for name, _, n in rows if k in name)]
                for k in ("ssd_", "flash_fwd", "rmsnorm")}
        emit("profile", arch=cfg.name, what=what, wall_ms=wall_ms,
             device_ms=device_ms,
             busy_share=device_ms / wall_ms if wall_ms else None,
             kernels=len(rows), ports_kernels_ms_launches=ours,
             top=[[name[:80], ms, n] for name, ms, n in top])


# --------------------------------------------------------------- main

def init_model(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    emit("init", arch=cfg.name, params=n_params,
         gb=n_params * 2 / 1e9, seconds=time.perf_counter() - t0)
    return cfg, params


def run_model(arch: str) -> dict:
    """One model's main path (prefill, and serving where the model is
    served), with the launch counts set to 0 just before it and read just
    after; then its checks and, where asked, its profile."""
    cfg, params = init_model(arch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # this model's main path starts here
    pre = phase_prefill(cfg, params)
    srv = phase_serve(cfg, params) if arch in SERVED else None
    launches = counts()                  # ... and ends here
    check_prefill(cfg, params, pre)
    del pre["logits"]
    if srv is not None:
        check_serve(cfg, params, srv)
        del srv["engine"]
    else:
        check_decode(cfg, params)
    if arch in PROFILED:
        phase_profile(cfg, params)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "per_prefill": pre["launches"],
            "serve": srv["launches"] if srv is not None else None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    dev = phase_device()
    if "--profile-only" in sys.argv[1:]:
        phase_build()
        for arch in PROFILED:
            cfg, params = init_model(arch)
            phase_profile(cfg, params)
            del params
            torch.cuda.empty_cache()
        return 0
    cases = phase_kernels(phase_build())
    if "--kernels-only" in sys.argv[1:]:
        return 0
    for arch in ARCHS:
        small_model_check(arch)
    paths = {arch: run_model(arch) for arch in ARCHS}

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        mine = [c for c in cases if c["kernel"] == name]
        timed = [c for c in mine if "ms" in c]
        r = timed[0]                     # the main path's first shape
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths.values()),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "timed_shape": r["shape"], "timed_dtype": r["dtype"],
            "cases_ok": sum(c["ok"] for c in mine), "cases": len(mine),
            "timed": [{k: c[k] for k in ("shape", "dtype", "variant", "ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "library_ms") if k in c}
                      for c in timed],
            "launches_by_path": {
                arch: {"path": p["launches"][name],
                       "per_prefill": p["per_prefill"][name],
                       "serve": None if p["serve"] is None
                       else p["serve"][name]}
                for arch, p in paths.items()},
        })
        variants = sorted({k.split("/", 1)[1] for p in paths.values()
                           for k in p["launches"] if k.startswith(name + "/")})
        if variants:
            kernels[-1]["variants"] = {
                v: sum(p["launches"][f"{name}/{v}"] for p in paths.values())
                for v in variants}
    print(json.dumps({"kernels": kernels}), flush=True)
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
