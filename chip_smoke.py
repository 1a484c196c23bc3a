#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   — the card's name, power limit and compute capability (the raw
                ``nvidia-smi --query-gpu=name,power.limit`` line is printed
                too); fails without CUDA.
  2. build    — the kernels' shared library from ``src/repro_torch/csrc``.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, at the serving path's shapes, in bf16 and f32 (TF32 off),
                with kernel / plain / library times (median of cold-L2 runs).
  4. prefill  — qwen3-1.7b at full width (random weights, seed 0): a reduced
                model on the card against the CPU, then ``make_prefill`` on
                4 x 1024 tokens, logits held against the plain-kernel forward.
  5. serve    — ``ServingEngine(batch=4, max_seq=512)`` answers 8 requests;
                one decode step with kernels against one with plain versions.
  6. profile  — one traced prefill and decode step: device time by kernel
                and the device's busy share (not part of the main path).
  7. the ``{"kernels": [...]}`` line: launches on the main path (phases 4-5,
     counted from 0), errors, times and bounds.

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the script exits non-zero without it.  Retrieval is off: the port has no
cache engine of its own yet.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12}              # f32 outside tensor cores
BF16_ULP = 2.0 ** -7                             # relative spacing of bf16
TOL = {torch.bfloat16: {"rmsnorm": 3e-2, "flash_attention": 2e-2},
       torch.float32: {"rmsnorm": 1e-5, "flash_attention": 5e-5}}
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.05            # tests/test_models.py
SMALL_F32_TOL = 1e-4                             # card vs CPU, f32 weights
SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:24"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:72"),
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

def phase_build() -> None:
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
    r = {"kernel": "flash_attention", "shape": [B, Sq, Skv, H, KV, hd],
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


def phase_kernels() -> dict:
    """Every case must pass; returns the timed main-path case per kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    results = []
    # (rows, d): attn/ffn/final norm over B*S = 4096 rows, q_norm over
    # B*S*16 rows, k_norm over B*S*8 rows, decode's 4 rows, a ragged count,
    # and llama3-405b's d_model.
    for rows, d, timed in [(4096, 2048, True), (65536, 128, True),
                           (32768, 128, True), (4, 2048, True),
                           (1000, 2048, False), (64, 16384, False)]:
        for dtype in (torch.bfloat16, torch.float32):
            results.append(rmsnorm_case(rows, d, dtype, gen, flush,
                                        timed and dtype == torch.bfloat16))
    for shape, causal, off, timed in [
            ((4, 1024, 1024, 16, 8, 128), True, 0, True),    # prefill
            ((2, 256, 1024, 16, 8, 128), True, 768, False),  # q_offset
            ((2, 128, 1601, 16, 8, 128), False, 0, False),   # 1601 image kv
            ((2, 512, 512, 8, 2, 64), True, 0, False),       # hd 64
            ((1, 1000, 1000, 16, 8, 128), True, 0, False),   # ragged Sq
            ((1, 130, 130, 4, 4, 32), True, 0, False),       # hd 32
            ((2, 16, 16, 4, 2, 16), True, 0, False)]:        # hd 16
        for dtype in (torch.bfloat16, torch.float32):
            results.append(flash_case(*shape, causal, off, dtype, gen, flush,
                                      timed))
    for r in results:
        emit("kernels", **r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    main = {"rmsnorm": results[0], "flash_attention": next(
        r for r in results if r["kernel"] == "flash_attention")}
    main["all"] = results
    return main


# --------------------------------------------------------------- phase 4

def counts() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    return {"rmsnorm": rmsnorm_cuda.launches,
            "flash_attention": flash_attention_cuda.launches}


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    rmsnorm_cuda.launches = 0
    flash_attention_cuda.launches = 0


def small_model_check() -> None:
    """Reduced qwen3 with f32 weights: the card (kernels) against the CPU
    (plain versions) on the same weights and tokens."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import forward, init_params
    cfg = reduced_config(ARCH)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    cpu = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
               else v.float()) for k, v in cpu.items()}
    gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in cpu.items()}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    with torch.inference_mode():
        want, _ = forward(cpu, cfg, toks, remat="none")
        got, _ = forward(gpu, cfg, toks.cuda(), remat="none")
    err = float((got.cpu() - want).abs().max())
    ok = bool(torch.allclose(got.cpu(), want, atol=SMALL_F32_TOL,
                             rtol=SMALL_F32_TOL))
    emit("prefill", check="reduced model, card vs CPU (f32)", ok=ok,
         max_abs_err=err, tol=SMALL_F32_TOL)
    if not ok:
        raise AssertionError(f"reduced model on the card differs from the "
                             f"CPU by {err}")


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
    per_forward = {k: (v - before[k]) // (runs + 1)
                   for k, v in counts().items()}
    if tuple(logits.shape) != (B, S, cfg.vocab):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    return {"logits": logits, "tokens": tokens, "ms": ms,
            "tokens_per_s": B * S / ms * 1e3, "launches": per_forward,
            "batch": B, "seq": S}


def check_prefill(cfg, params, pre) -> None:
    from repro_torch.serve.serve_step import make_prefill
    ref = make_prefill(cfg, "cuda", force_ref=True)(params, pre["tokens"])
    got, want = pre["logits"].float(), ref.float()
    ok = bool(torch.allclose(got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL))
    emit("prefill", arch=cfg.name, batch=pre["batch"], seq=pre["seq"],
         ok=ok, ms=pre["ms"], tokens_per_s=pre["tokens_per_s"],
         launches_per_forward=pre["launches"],
         max_abs_err=float((got - want).abs().max()),
         logits_max_abs=float(want.abs().max()),
         tol={"atol": LOGITS_ATOL, "rtol": LOGITS_RTOL},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not ok:
        raise AssertionError("prefill logits with kernels differ from the "
                             "plain-kernel forward")


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


def check_serve(cfg, params, srv) -> None:
    from repro_torch.serve.serve_step import make_serve_step
    eng = srv["engine"]
    kv_mb = (eng.state["k"].numel() + eng.state["v"].numel()) * 2 / 1e6
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (eng.batch, 1)))
    outs = []
    for force_ref in (False, True):
        state = {"pos": eng.state["pos"], "k": eng.state["k"].clone(),
                 "v": eng.state["v"].clone()}
        lg, _ = make_serve_step(cfg, "cuda", force_ref=force_ref)(
            params, state, toks)
        outs.append(lg.float())
    ok = srv["ok"] and bool(torch.allclose(outs[0], outs[1], atol=LOGITS_ATOL,
                                           rtol=LOGITS_RTOL))
    per_step = {k: v / max(1, srv["steps"]) for k, v in srv["launches"].items()}
    emit("serve", arch=cfg.name, ok=ok, requests=srv["requests"],
         tokens=srv["tokens"], steps=srv["steps"], seconds=srv["seconds"],
         tokens_per_s=srv["tokens"] / srv["seconds"],
         ms_per_decode_step=srv["seconds"] / max(1, srv["steps"]) * 1e3,
         launches_per_decode_step=per_step, kv_cache_mb=kv_mb,
         decode_max_abs_err=float((outs[0] - outs[1]).abs().max()),
         retrieval="off")
    if not ok:
        raise AssertionError("serving failed: unfinished requests or decode "
                             "logits with kernels differ from plain versions")


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
        emit("profile", what=what, wall_ms=wall_ms, device_ms=device_ms,
             busy_share=device_ms / wall_ms if wall_ms else None,
             kernels=len(rows),
             top=[[name[:80], ms, n] for name, ms, n in top])


# --------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    dev = phase_device()
    phase_build()
    kern = phase_kernels()
    small_model_check()

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    emit("init", arch=cfg.name, params=n_params,
         gb=n_params * 2 / 1e9, seconds=time.perf_counter() - t0)

    reset_counts()                       # the main path starts here
    pre = phase_prefill(cfg, params)
    srv = phase_serve(cfg, params)
    main_path = counts()                 # ... and ends here
    check_prefill(cfg, params, pre)
    del pre["logits"]
    check_serve(cfg, params, srv)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = kern[name]
        cases = [c for c in kern["all"] if c["kernel"] == name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_path[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "timed_shape": r["shape"], "timed_dtype": r["dtype"],
            "cases_ok": sum(c["ok"] for c in cases), "cases": len(cases),
            "launches_per_prefill": pre["launches"][name],
            "launches_serve": srv["launches"][name],
        })
    phase_profile(cfg, params)
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
