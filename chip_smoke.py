#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase (the main path)
    python3 chip_smoke.py --kernels-only  # phases 1-3 only: build and check
                                          # the kernels, then stop
    python3 chip_smoke.py --profile-only  # phases 1, 2 and 7, and the traced
                                          # train step of phase 6
    python3 chip_smoke.py --profile-only zamba2-1.2b mamba2-370m
                                          # ... of the models named only

Phases, each printing one JSON line (``{"phase": ...}``):

  1. device   — the card's name, power limit and compute capability (the raw
                ``nvidia-smi --query-gpu=name,power.limit`` line is printed
                too); fails without CUDA.
  2. build    — the kernels' shared library from ``src/repro_torch/csrc``.
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card (TF32 off), with kernel / plain / library times (median
                of cold-L2 runs): RMSNorm and flash attention forward and
                backward in bf16 and f32 at the serving and training paths'
                shapes (GQA groups 1-8, d_model 1024-2048, the q/k norms'
                row counts), the SSD chunk kernel and its backward in f32
                (the backward twice: the same bits; at a rank's shard of
                the 2 x 2 paths too); ``ssd`` (chunk kernel +
                recurrence) against ``ssd_ref`` at the zamba2 prefill shape,
                and its gradient (both SSD kernels under autograd) against
                autograd of ``ssd_ref``.
  4. prefill  — per model: a reduced model on the card against the CPU (f32
                weights; audio on frame embeddings, vlm on random image
                embeddings with nonzero gates), then ``make_prefill`` at
                full width (random weights, seed 0, bf16) on 4 x 1024 tokens
                (musicgen: 4 x 1024 frame embeddings; llama-vision: with 4
                random images of 1601 embeddings, on its first 20 of 100
                layers), launches per forward checked, the main path's
                logits held against the plain-kernel forward on the same
                bf16 weights (``kernels_vs_plain``; MoE: with the routing
                agreement, see ``pair_check``).
  5. serve    — every model but mamba2-370m: ``ServingEngine(batch=4,
                max_seq=512)`` answers 8 requests (token ids; llama-vision
                with no image, as the reference's engine serves it), each
                retrieving 4 passages through the port's own IGTCache
                client; one decode step with kernels against one with plain
                versions (mamba2-370m: the same comparison after a few
                decode steps; musicgen on a frame embedding; llama-vision
                also after a few steps on an image state).  Last, each
                model's f32 pairs (``check_f32``): prefill and a decode step
                with the weights cast to f32, kernels against plain
                versions; qwen3-moe's and llama-vision's on a copy of their
                first ``F32_DEPTH`` layers, made after the full weights are
                freed.
  6. train    — per trained model (qwen3-1.7b, granite-moe-3b-a800m,
                zamba2-1.2b, mamba2-370m, musicgen-large on frame
                embeddings drawn from the seed): the
                reduced model trained 4 steps on the card against the CPU
                (f32); the launcher (``repro_torch.launch.train``, qwen3) on
                the card with a checkpoint and a resume; then the model at
                full width: ``make_train_step`` (remat "full", dense loss,
                AdamW) on 4 x 1024-token batches from the launcher's
                ``CachedTokenPipeline``, launches per step checked, one
                step's loss and gradients held against plain versions in
                bf16 and f32 (ssm / hybrid: f32 within twice the plain
                path's own floor, and at 1e-4 on the model's first
                ``F32_TRAIN_DEPTH`` layers; bf16 beside a floor of order
                1, see TRAIN_TOL), and one traced step.  llama-vision: one
                loss-and-grads on its first ``GRAD_DEPTH`` layers (the
                non-causal flash backward), held against plain versions in
                bf16.
  6b. mesh    — ``mesh/qwen3-1.7b``: qwen3-1.7b at full
                width and depth through a one-device mesh
                (``make_local_mesh("cuda")``, ``DEFAULT_RULES``): prefill,
                8 decode steps and 2 train steps through the mesh steps,
                logits and the first loss bitwise equal to the unmeshed
                steps', params within twice two unmeshed runs' spread,
                launches equal to the qwen3 paths', a checkpoint restored
                with shardings (``run_mesh`` lists its checks).  Each step
                beside its lowered twin, traced on ``meta`` tensors on the
                same mesh and rules (``mesh_twin`` lines: argument bytes
                held equal to the real tensors'; predicted memory, roofline
                ms and traced FLOPs printed beside the step's measured
                footprint, event ms and ``train_step_flops``).  Its
                process group is destroyed when it ends, so no later fork
                inherits a live group.
  6b2. mesh2x2 — ``mesh2x2/<arch>`` for qwen3-1.7b, zamba2-1.2b,
                mamba2-370m, granite-moe-3b-a800m, musicgen-large and
                llama-3.2-vision-90b (depths by ``MESH2_RUNS``), then
                qwen3-1.7b decoding under ``decode_weights_stationary``
                (its KV cache split along the sequence): the mesh path's
                steps for each
                model at full width on a real (2, 2) ("data", "model")
                ``DeviceMesh`` of four ranks spawned on the one card (gloo
                with CUDA tensors, the functional all-gather staged
                through the host), params, batch and decode state
                DTensors placed by ``DEFAULT_RULES``, the kernels (the SSD
                chunk and its backward too) run on each rank's local
                shards: bf16 logits, first loss and first grad norm
                within ``FLOOR_FACTOR`` times the unmeshed
                kernels-against-plain gap (plus one ulp; ssm / hybrid /
                audio: against their f32 evaluation, within twice the
                farthest one-device bf16 evaluation's gap to it), f32
                cuts at 1e-4 (ssm / hybrid logits: or twice the cut's
                f32 kernels-against-plain gap), each rank's launches equal
                to the expected counts, each step's collectives
                (``CollectiveTally``) equal to the dry-run twin's count of
                it on the rank's mesh (``twin_collectives``; the twin's
                predicted FLOPs, bytes, temp and bytes per device printed
                beside the rank's ms and peak memory, ``mesh2_collectives``
                lines), peak memory a rank and the card's memory in use
                (``run_mesh2`` lists its checks).
  6c. unified — ``unified/qwen3-1.7b``: qwen3-1.7b at full width and depth
                (bf16, seed 0) trains and serves through ONE process-driver
                cache client (``open_cache(driver="process", n_procs=2)``,
                the process executor, demand bytes through the
                shared-memory arena) over ``tiered+sim://`` (a 16 MB RAM
                and 256 MB disk tier) holding the launcher's 64 MB token
                corpus and the 32 MB knowledge set, with a 48 MB cache: 4
                train steps from ``CachedTokenPipeline``, a
                ``ServingEngine`` answering 8 requests with 4 retrievals
                each, 4 more train steps (``run_unified`` lists its checks).
  6d. cache   — host phase, no GPU: the daemon walkthrough (a
                ``CacheDaemon`` over two shard worker processes, two
                ``cache://`` sessions) and the ``tiered+mock-s3://``
                walkthrough of examples/quickstart_torch.py.
  6e. sim     — host phase, no GPU, in this CUDA-holding process: the
                paper's 18-job mixed cluster on the port's simulator at a
                quarter scale (igtcache, juicefs, nocache, igtcache again;
                examples/mixed_cluster_torch.py), then a worker of a
                process-driver client killed mid-trace
                (``phase_sim`` lists its checks).
  6f. dryrun  — host phase, no GPU: ``python -m repro_torch.launch.dryrun
                --all --mesh both`` (each cell's FLOPs, bytes, temp and
                collectives one rank's step counted on ``meta`` DTensors
                over torch's fake group, at two depths and extrapolated;
                ``dominant`` counts the cells by their roofline's largest
                term) and ``paper_cells`` (the
                cells one card cannot hold, lowered on a 1 x 1 mesh),
                started before phase 2 in processes of their own with no
                card visible, so that they run beside the card's phases
                (``sweep_wall_s``: when the sweep ended); then
                ``python -m repro_torch.roofline.report`` on the sweep's
                rows (``phase_dryrun`` lists its checks).
  7. profile  — one traced prefill and decode step of each model: device
                time by kernel (and summed for each of the port's kernels)
                and the device's busy share (not part of the main path).
                ``--profile-only`` runs this phase and the traced train
                step (on a random batch) alone; copied into an older
                checkout, it profiles that checkout's package.
  8. the ``{"kernels": [...]}`` line: launches on the main path (each
     model's prefill and serving, each model's train steps
     (``train/<arch>``), ``mesh/qwen3-1.7b``, the three ``mesh2x2/`` paths
     (each one's four ranks' launches summed) and ``unified/qwen3-1.7b``,
     each counted from 0 and summed; flash attention's forward and backward also by variant,
     and every prefill and training flash launch must be the ``wgmma``
     one), errors, times and bounds, for the three forward kernels and the
     three backward ones.

The models, in order: qwen3-1.7b (dense; RMSNorm and flash attention),
zamba2-1.2b (hybrid; all three forward kernels), mamba2-370m (ssm; RMSNorm
and the SSD chunk kernel; prefill and training, not served),
granite-moe-3b-a800m and qwen3-moe-30b-a3b (moe; RMSNorm and flash
attention at GQA groups 3 and 8), musicgen-large (audio; the dense kernels
on frame embeddings) and llama-3.2-vision-90b (vlm; RMSNorm at d 8192,
causal flash attention at H64/KV8/hd128, and non-causal cross-attention
over 1601 image tokens: prefill's Sq 1024 and decode's Sq 1), then
qwen3-1.7b, granite-moe-3b-a800m, zamba2-1.2b, mamba2-370m and
musicgen-large training, and llama-vision's loss and grads (the forwards
and the RMSNorm, flash and SSD chunk backwards).

The last line is ``{"ok": true, "device": {...}}``; any failed phase raises
and the script exits non-zero without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
STARTED = time.perf_counter()
VLM, AUDIO = "llama-3.2-vision-90b", "musicgen-large"
ARCHS = ("qwen3-1.7b", "zamba2-1.2b", "mamba2-370m", "granite-moe-3b-a800m",
         "qwen3-moe-30b-a3b", AUDIO, VLM)
SERVED = ("qwen3-1.7b", "zamba2-1.2b", "granite-moe-3b-a800m",
          "qwen3-moe-30b-a3b", AUDIO, VLM)       # main path: prefill + serve
PROFILED = ARCHS
# Models run at full width on fewer layers than their config's: 100 layers
# of llama-3.2-vision-90b are 88.6 G params (177 GB in bf16); 20 (with its
# 4 cross layers) are 19.82 G, 39.6 GB.
DEPTH = {VLM: 20}
# Models whose f32 pairs (kernels vs plain) run on a copy of their first
# layers (with embed, final norm and head, and a vlm's cross layers among
# them): qwen3-moe's 30.5 G params are 61 GB in bf16 and would be 122 GB in
# f32; llama-vision's 20 layers would be 79 GB.  The others run at full
# depth.
F32_DEPTH = {"qwen3-moe-30b-a3b": 4, VLM: 5}
# llama-vision's loss and grads (no AdamW: params, grads and moments take
# ~78 GB at any depth from 5) run on its first GRAD_DEPTH layers, one cross
# layer among them.
GRAD_DEPTH = 5
# A MoE pair whose routing differs may flip at most this many times the
# (layer, token) routes that the plain path's floor flips (``routes_held``).
ROUTE_FACTOR = 3
# Reduced training: AdamW's step m / (sqrt(v) + eps) cannot hold an element
# whose sqrt(v) lies within this many eps (``small_train_check``).
ADAMW_NEAR_EPS = 4
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12}              # f32 outside tensor cores
PEAK_TF32 = 495e12                               # dense tensor-core TF32
BF16_ULP = 2.0 ** -7                             # relative spacing of bf16
# Kernel tolerances, as in tests/test_kernels.py.  The backwards take the
# forward ones scaled to a gradient: bf16 2e-2 plus one bf16 ulp of the
# value; f32 1e-4 of the leaf's largest magnitude (the products and the
# atomics sum in other orders than the plain version); dw, a sum over every
# row, against its norm at the same relative tolerance.
TOL = {torch.bfloat16: {"rmsnorm": 3e-2, "flash_attention": 2e-2,
                        "rmsnorm_bwd": 2e-2, "flash_attention_bwd": 2e-2},
       torch.float32: {"rmsnorm": 1e-5, "flash_attention": 5e-5,
                       "ssd_chunk": 1e-4, "ssd": 1e-4,
                       "rmsnorm_bwd": 1e-4, "flash_attention_bwd": 1e-4,
                       "ssd_chunk_bwd": 1e-4, "ssd_grad": 1e-4}}
LOGITS_ATOL, LOGITS_RTOL = 0.15, 0.05            # tests/test_models.py
SMALL_F32_TOL = 1e-4                             # card vs CPU, f32 weights
SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:24"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:72"),
    "ssd_chunk": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd/kernel.py:44"),
    # The TPU kernels have no backward: these are the gradients of the three
    # above, which the JAX package takes through their plain references.
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:24"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:72"),
    "ssd_chunk_bwd": ("src/repro_torch/csrc/ssd_chunk_bwd.cu",
                      "src/repro/kernels/ssd/kernel.py:44"),
}


def emit(phase: str, **kw) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``at_s``)."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - STARTED}), flush=True)


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


SPIN_CYCLES = 2_000_000                          # ~1 ms of the card's clock


def time_ms(fn, flush: torch.Tensor, iters: int = 20) -> float:
    """Median device time of ``fn`` over ``iters`` runs, each after a write
    of ``flush`` (larger than the 50 MB L2) so inputs come from HBM, then a
    ~1 ms spin on the card: the host enqueues ``fn`` while the card spins,
    so a slow host's launch latency does not land between the events."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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
    return kernel_build(build, "ssd_chunk_kernel", f"ILi{p}ELi{n}E")


def kernel_build(build: dict, kernel: str, args: str) -> dict:
    """ptxas's numbers for the entry ``kernel`` whose mangled template
    arguments start with ``args``."""
    for name, info in build.items():
        if f"{kernel}{args}" in name:
            return info
    return {}


def bwd_build(build: dict, kernel: str, dtype, d: int) -> dict:
    """ptxas's numbers for the backward kernel a case launches:
    ``flash_bwd_*_kernel<hd, ...>`` (d = head dim) or
    ``rmsnorm_bwd_kernel<T, V, TPR>`` (d = row width), chosen as the plans
    (``bwd_plan``, ``rmsnorm_bwd_plan``) choose them."""
    if kernel == "flash_attention_bwd":
        from repro_torch.kernels.flash_attention.kernel import bwd_plan
        p = bwd_plan(dtype, d, 1, 128, 1)
        name, args = {
            "wgmma": ("flash_bwd_wgmma_kernel", f"ILi{d}ELi{p.stages}E"),
            "mma_sync": ("flash_bwd_mma_kernel", f"ILi{d}E"),
            "fma": ("flash_bwd_fma_kernel", f"ILi{d}E")}[p.variant]
        return kernel_build(build, name, args)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_plan
    size = 2 if dtype == torch.bfloat16 else 4
    p = rmsnorm_bwd_plan(1, d, size)
    t = "13__nv_bfloat16" if dtype == torch.bfloat16 else "f"
    if p.groups == 1:                    # rows of more than 512 vectors
        return kernel_build(build, "rmsnorm_bwd_long_kernel",
                            f"I{t}Li{p.vecs}EE")
    return kernel_build(build, "rmsnorm_bwd_kernel",
                        f"I{t}Li{p.vecs}ELi{p.lanes}E")


# --------------------------------------------------------------- phase 3

def mixed_rmsnorm_case(rows, d, gen):
    """x bf16 with an f32 weight (musicgen's first norm under f32 weights)
    through the dispatch (``ops.rmsnorm``: the f32 kernels on x.float(),
    the result cast to bf16) and its autograd backward, against
    ``rmsnorm_ref`` and ``rmsnorm_bwd_ref`` of the same mix: y and dx in
    bf16 at the bf16 tolerances, dw in f32 by its relative L2 error."""
    from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd_ref,
                                             rmsnorm_ref)
    bf16 = torch.bfloat16
    x = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(bf16)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = rmsnorm(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    rx, rw = rmsnorm_bwd_ref(x, w, dy)
    ok_y, err_y = close_enough(y, rmsnorm_ref(x, w), TOL[bf16]["rmsnorm"], bf16)
    ok_x, err_x = grad_close(dx, rx, bf16, "rmsnorm_bwd")
    dw_rel = rel_l2(dw, rw)
    tol = TOL[torch.float32]["rmsnorm_bwd"]
    return {"kernel": "rmsnorm", "check": "x bf16, w f32: forward and "
            "backward through ops.rmsnorm", "shape": [rows, d],
            "dtype": "bfloat16/float32",
            "out_dtypes": [str(t.dtype)[6:] for t in (y, dx, dw)],
            "ok": (ok_y and ok_x and dw_rel <= tol
                   and (y.dtype, dx.dtype, dw.dtype) == (bf16, bf16,
                                                         torch.float32)),
            "max_abs_err": err_y, "max_abs_err_dx": err_x, "dw_rel_l2": dw_rel,
            "tol": {"y": TOL[bf16]["rmsnorm"], "dx": TOL[bf16]["rmsnorm_bwd"],
                    "dw_rel_l2": tol}}


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


def sdpa_computes(Sq, Skv, causal, q_offset) -> bool:
    """Whether one ``F.scaled_dot_product_attention`` call computes the same
    function: no mask, or the causal one when Sq == Skv (SDPA's causal mask
    is aligned to the top left, the kernels' to q_offset)."""
    return q_offset == 0 and (not causal or Sq == Skv)


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
                 library_ms=(time_ms(sdpa, flush) if sdpa_computes(
                     Sq, Skv, causal, q_offset) else None),
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        r["tflops"] = flops / r["ms"] / 1e9
    return r


def grad_close(got, want, dtype, kind: str) -> tuple:
    """(ok, max_abs_err) of one gradient leaf at the backward tolerance: bf16
    ``close_enough`` at 2e-2 (plus one ulp); f32 within 1e-4 of the leaf's
    largest magnitude."""
    tol = TOL[dtype][kind]
    if dtype == torch.float32:
        tol = tol * max(float(want.abs().max()), 1e-30)
    return close_enough(got, want, tol, dtype)


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def rmsnorm_bwd_case(rows, d, dtype, gen, flush, timed, build):
    """``rmsnorm_bwd_cuda`` against ``rmsnorm_bwd_ref`` on the same x, w, dy:
    dx at the gradient tolerance, dw by its relative L2 error."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_bwd_ref
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(dtype)
    dy = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    (dx, dw), (rx, rw) = rmsnorm_bwd_cuda(x, w, dy), rmsnorm_bwd_ref(x, w, dy)
    tol = TOL[dtype]["rmsnorm_bwd"]
    ok_x, err = grad_close(dx, rx, dtype, "rmsnorm_bwd")
    dw_rel = rel_l2(dw, rw)
    r = {"kernel": "rmsnorm_bwd", "shape": [rows, d], "dtype": str(dtype)[6:],
         "ok": ok_x and dw_rel <= tol, "max_abs_err": err,
         "dw_rel_l2": dw_rel, "tol": tol,
         **bwd_build(build, "rmsnorm_bwd", dtype, d)}
    if timed:
        nbytes = (3 * rows * d + 2 * d) * x.element_size()
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = F.rms_norm(xg, (d,), wg, 1e-5)
        r.update(ms=time_ms(lambda: rmsnorm_bwd_cuda(x, w, dy), flush),
                 plain_ms=time_ms(lambda: rmsnorm_bwd_ref(x, w, dy), flush),
                 library_ms=time_ms(lambda: torch.autograd.grad(
                     y, (xg, wg), dy, retain_graph=True), flush),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    return r


def flash_bwd_case(B, Sq, Skv, H, KV, hd, causal, q_offset, dtype, gen, flush,
                   timed, build):
    """``flash_attention_bwd_cuda`` against ``flash_attention_bwd_ref`` on the
    same q, k, v, dO and the forward kernel's o and lse."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_bwd_ref,
                                                     flash_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import bwd_plan
    q = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, Skv, KV, hd, generator=gen, device="cuda").to(dtype)
    do = torch.randn(B, Sq, H, hd, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    oks, errs = zip(*(grad_close(g, w, dtype, "flash_attention_bwd")
                      for g, w in zip(got, want)))
    p = bwd_plan(dtype, hd, B, Skv, KV, torch.cuda.get_device_properties(
        0).multi_processor_count)
    ptxas = bwd_build(build, "flash_attention_bwd", dtype, hd)
    r = {"kernel": "flash_attention_bwd", "shape": [B, Sq, Skv, H, KV, hd],
         "variant": p.variant, "grid": list(p.grid),
         "smem": p.smem_bytes + ptxas.get("static_smem", 0), "causal": causal,
         "q_offset": q_offset, "dtype": str(dtype)[6:], "ok": all(oks),
         "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": list(errs),
         "rel_l2_dq_dk_dv": [rel_l2(g, w) for g, w in zip(got, want)],
         "tol": TOL[dtype]["flash_attention_bwd"], **ptxas}
    del got, want
    if timed:
        # Five products against the forward's two.
        flops = 2.5 * attention_work(B, Sq, Skv, H, hd, causal, q_offset)
        nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                  + 4 * lse.numel())
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=True)
        dot = do.transpose(1, 2)
        r.update(ms=time_ms(lambda: flash_attention_bwd_cuda(
                     q, k, v, o, lse, do, **kw), flush),
                 plain_ms=time_ms(lambda: flash_attention_bwd_ref(
                     q, k, v, o, lse, do, **kw), flush, iters=3),
                 library_ms=(time_ms(lambda: torch.autograd.grad(
                     out, (qt, kt, vt), dot, retain_graph=True), flush)
                     if sdpa_computes(Sq, Skv, causal, q_offset) else None),
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


def ssd_bwd_work(b, c, l, h, p, n):
    """(FLOPs, bytes) of the SSD chunk's backward.  FLOPs over the P =
    l(l+1)/2 kept pairs: G = C Bᵀ recomputed (2 n P) and dC = dG B, dB =
    dGᵀ C (4 n P) once per (b, c), where dG sums the heads; per (b, c, h)
    dM = dy xᵀ and dx += Mᵀ dy (4 p P) and the two state terms, x dS and
    (B ∘ w) dSᵀ (4 l n p).  Bytes: x, a, B, C, dy, dstates read once; dx,
    da, dB, dC written once, f32."""
    pairs = l * (l + 1) // 2
    flops = b * c * (6 * n * pairs + h * (4 * p * pairs + 4 * l * n * p))
    nbytes = 4 * b * c * (3 * l * h * p + h * p * n + 2 * l * h + 4 * l * n)
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


def ssd_chunk_bwd_case(b, c, l, h, p, n, scale_bc, gen, flush, timed,
                       build):
    """``ssd_chunk_bwd_cuda`` against ``ssd_chunk_bwd_ref`` on the same
    inputs and cotangents: each of dx, da, dB, dC within 1e-4 of its largest
    magnitude; a second launch must give the same bits (dB and dC are summed
    across head groups in a fixed order, not by atomics)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ssd_chunk_bwd_cuda, ssd_chunk_bwd_ref
    from repro_torch.kernels.ssd.kernel import bwd_plan
    x, a, B, C = ssd_inputs((b, c, l, h, p), (b, c, l, h), (b, c, l, n),
                            scale_bc, gen)
    dy = torch.randn(b, c, l, h, p, generator=gen, device="cuda")
    ds = torch.randn(b, c, h, p, n, generator=gen, device="cuda")
    args = (x, a, B, C, dy, ds)
    got, want = ssd_chunk_bwd_cuda(*args), ssd_chunk_bwd_ref(*args)
    again = ssd_chunk_bwd_cuda(*args)
    same = all(torch.equal(g, r) for g, r in zip(got, again))
    oks, errs = zip(*(grad_close(g, w, torch.float32, "ssd_chunk_bwd")
                      for g, w in zip(got, want)))
    pl = bwd_plan(b, c, l, h, p, n)
    ptxas = kernel_build(build, "ssd_chunk_bwd_kernel", f"ILi{p}ELi{n}E")
    smem = _build.load().ssd_chunk_bwd_smem_bytes(l, p, n)
    r = {"kernel": "ssd_chunk_bwd", "shape": [b, c, l, h, p, n],
         "dtype": "float32",
         "ok": all(oks) and same and smem == pl.smem_bytes,
         "max_abs_err": max(errs), "max_abs_err_dx_da_dB_dC": list(errs),
         "rel_l2_dx_da_dB_dC": [rel_l2(g, w) for g, w in zip(got, want)],
         "tol": "1e-4 of each output's largest magnitude",
         "bitwise_repeat": same, "blocks": pl.blocks,
         "head_group": pl.head_group, "workspace_mb": pl.ws_floats * 4 / 1e6,
         "regs": ptxas.get("regs"), "spill_bytes": ptxas.get("spill_bytes"),
         "smem": smem + ptxas.get("static_smem", 0),
         "smem_plan_matches": smem == pl.smem_bytes}
    del got, want, again
    if timed:
        flops, nbytes = ssd_bwd_work(b, c, l, h, p, n)
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        r.update(ms=time_ms(lambda: ssd_chunk_bwd_cuda(*args), flush),
                 plain_ms=time_ms(lambda: ssd_chunk_bwd_ref(*args), flush,
                                  iters=5),
                 library_ms=None,      # no single PyTorch call computes it
                 bound_ms=max(t_ops, t_bytes),
                 bound_by="operations" if t_ops >= t_bytes else "bytes",
                 # The floor of a 3xTF32 tensor-core design.
                 bound_tc_ms=max(3 * flops / PEAK_TF32 * 1e3, t_bytes),
                 # The three launches apart (a trace of 5 warm calls): the
                 # main kernel and the two finishing ones.
                 traced_ms=device_ms_by_name(
                     lambda: ssd_chunk_bwd_cuda(*args),
                     ("ssd_chunk_bwd_kernel", "ssd_chunk_bwd_bc_kernel",
                      "ssd_chunk_bwd_da_kernel")))
        r["tflops"] = flops / r["ms"] / 1e9
    return r


def device_ms_by_name(fn, names, reps: int = 5) -> dict:
    """Device ms per call of the kernels whose names contain each of
    ``names``, from one trace of ``reps`` warm calls of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {k: sum(ms for name, ms in rows if k in name) / reps
            for k in names}


def ssd_grad_case(b, s, h, p, n, chunk, gen):
    """The gradient of ``ssd`` on the card (the ``ssd_chunk`` Function's two
    kernels + the recurrence under autograd) against ``force_ref`` (autograd
    of ``ssd_ref``), with cotangents on y and on the final state: each
    input's gradient within 1e-4 of its largest magnitude."""
    from repro_torch.kernels.ssd import ssd
    prims = ssd_inputs((b, s, h, p), (b, s, h), (b, s, n), n ** -0.5, gen)
    dy = torch.randn(b, s, h, p, generator=gen, device="cuda")
    dfinal = torch.randn(b, h, p, n, generator=gen, device="cuda")
    grads = []
    for force_ref in (False, True):
        leaves = [t.clone().requires_grad_(True) for t in prims]
        y, final = ssd(*leaves, chunk=chunk, force_ref=force_ref)
        grads.append(torch.autograd.grad((y, final), leaves, (dy, dfinal)))
    oks, errs = zip(*(grad_close(g, w, torch.float32, "ssd_grad")
                      for g, w in zip(*grads)))
    return {"kernel": "ssd_grad", "shape": [b, s, h, p, n], "chunk": chunk,
            "dtype": "float32", "ok": all(oks), "max_abs_err": max(errs),
            "max_abs_err_x_a_B_C": list(errs),
            "tol": "1e-4 of each gradient's largest magnitude"}


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
    # mamba2's layer norm, a ragged count, llama3-405b's d_model, granite's
    # d_model, and qwen3-moe's q / k norms (B*S*32, B*S*4 rows).
    # llama-vision's d_model (4 x 1024 rows) and decode's 4 rows.  A rank's
    # shard of qwen3 on the (2, 2) mesh: 2 x 1024 rows of d_model (zamba2's
    # too), its 4 KV heads' norms (its 8 q heads' 16384 rows are a case
    # above) and decode's 2 rows; mamba2's 2 x 1024 rows of its d_model;
    # granite's 2 x 1024 rows of its d_model (timed); musicgen's (timed, the
    # (2048, 2048) case) and llama-vision's (2048, 8192) (timed).
    for rows, d, timed in [(4096, 2048, True), (65536, 128, True),
                           (32768, 128, True), (4, 2048, True),
                           (4096, 1024, True), (1000, 2048, False),
                           (64, 16384, False), (4096, 1536, True),
                           (131072, 128, True), (16384, 128, False),
                           (4096, 8192, True), (4, 8192, False),
                           (2048, 2048, True), (8192, 128, False),
                           (2, 2048, False), (2048, 1024, False),
                           (2048, 1536, True), (2048, 8192, True)]:
        for dtype in (torch.bfloat16, torch.float32):
            results.append(rmsnorm_case(rows, d, dtype, gen, flush,
                                        timed and dtype == torch.bfloat16))
    # x bf16 with w f32: musicgen's width, and a ragged row count.
    for rows, d in [(4096, 2048), (1000, 8192)]:
        results.append(mixed_rmsnorm_case(rows, d, gen))
    bf16, f32 = torch.bfloat16, torch.float32
    for shape, causal, off, timed in [
            ((4, 1024, 1024, 16, 8, 128), True, 0, (bf16, f32)),  # qwen3
            ((4, 1024, 1024, 32, 32, 64), True, 0, (bf16,)),  # zamba2 shared
            ((2, 256, 1024, 16, 8, 128), True, 768, ()),      # q_offset
            ((2, 128, 1601, 16, 8, 128), False, 0, ()),       # 1601 image kv
            ((2, 512, 512, 8, 2, 64), True, 0, ()),           # hd 64
            ((1, 1000, 1000, 16, 8, 128), True, 0, ()),       # ragged Sq
            ((1, 130, 130, 4, 4, 32), True, 0, ()),           # hd 32
            ((2, 16, 16, 4, 2, 16), True, 0, ()),             # hd 16
            ((4, 1024, 1024, 24, 8, 64), True, 0, (bf16,)),   # granite, GQA 3
            ((4, 1024, 1024, 32, 4, 128), True, 0, (bf16,)),  # qwen3-moe, 8
            ((1, 1000, 1000, 6, 2, 64), True, 0, ()),         # ragged group 3
            # llama-vision: cross-attention over 1601 image tokens (prefill
            # and decode's one row, whose 128-row Q tile holds one valid row
            # and whose last KV tile 65 keys), and its self-attention.
            ((4, 1024, 1601, 64, 8, 128), False, 0, (bf16,)),
            ((4, 1, 1601, 64, 8, 128), False, 0, (bf16,)),
            ((4, 1024, 1024, 64, 8, 128), True, 0, (bf16,)),
            ((2, 1024, 1024, 8, 4, 128), True, 0, ()),    # qwen3, 2x2 shard
            # zamba2's and musicgen's 2x2 shard
            ((2, 1024, 1024, 16, 16, 64), True, 0, (bf16,)),
            ((2, 1024, 1024, 12, 4, 64), True, 0, (bf16,)),   # granite, 2x2
            # llama-vision's 2x2 shard of its cross-attention: prefill, and
            # decode's one query row
            ((2, 1024, 1601, 32, 4, 128), False, 0, (bf16,)),
            ((2, 1, 1601, 32, 4, 128), False, 0, (bf16,))]:
        for dtype in (bf16, f32):
            results.append(flash_case(*shape, causal, off, dtype, gen, flush,
                                      dtype in timed))
    # (b, c, l, h, p, n, B/C scale): zamba2 and mamba2 prefill (4 x 1024
    # tokens), the reduced configs, tests/test_kernels.py's shape, a chunk
    # that is not a multiple of the 64-row tile, ragged head groups (5
    # heads in one group; 9 in groups of 5 and 4), and a rank's shard of
    # zamba2 and of mamba2 on the (2, 2) mesh (2 sequences, half the heads).
    ssd_shapes = [(4, 4, 256, 64, 64, 64, 64 ** -0.5, True),
                  (4, 4, 256, 32, 64, 128, 128 ** -0.5, True),
                  (2, 2, 32, 8, 16, 16, 1.0, False),
                  (1, 4, 16, 2, 16, 8, 1.0, False),
                  (1, 3, 48, 3, 16, 16, 1.0, False),
                  (1, 2, 200, 5, 64, 64, 64 ** -0.5, False),
                  (2, 1, 256, 9, 64, 128, 128 ** -0.5, False),
                  (2, 4, 256, 32, 64, 64, 64 ** -0.5, True),
                  (2, 4, 256, 16, 64, 128, 128 ** -0.5, True)]
    for *shape, scale, timed in ssd_shapes:
        results.append(ssd_chunk_case(*shape, scale, gen, flush, timed,
                                      build))
    results.append(ssd_ops_case(4, 1024, 64, 64, 64, 256, gen))
    # The SSD chunk's backward at the same shapes: zamba2's and mamba2's
    # train steps (4 x 1024 tokens) and a rank's shards of them timed, the
    # rest untimed.
    for *shape, scale, timed in ssd_shapes:
        results.append(ssd_chunk_bwd_case(*shape, scale, gen, flush, timed,
                                          build))
    results.append(ssd_grad_case(4, 1024, 64, 64, 64, 256, gen))
    # Backwards (the train phase's kernels).  RMSNorm (rows, d): the qwen3
    # train step's norms over 4 x 1024 tokens (d_model, then the q and k
    # norms), a ragged row count, the reduced config's d_model and head dim,
    # granite's d_model, llama-vision's d_model (the long-row kernel; in f32
    # eight vectors a thread), an f32 width just past the row groups' 512
    # vectors, fewer long rows than CTAs, a rank's shard of qwen3 on the
    # (2, 2) mesh (d_model, the q and the k norms; musicgen's too, timed),
    # of mamba2 and of granite (timed).
    for rows, d, timed in [(4096, 2048, True), (65536, 128, True),
                           (32768, 128, False), (1000, 2048, False),
                           (80, 64, False), (640, 16, False),
                           (4096, 1536, True), (4096, 8192, True),
                           (1000, 2056, False), (7, 8192, False),
                           (2048, 2048, True), (16384, 128, False),
                           (8192, 128, False), (2048, 1024, False),
                           (2048, 1536, True)]:
        for dtype in (bf16, f32):
            results.append(rmsnorm_bwd_case(rows, d, dtype, gen, flush,
                                            timed and dtype == bf16, build))
    # Flash: qwen3's train shape (timed in both types), zamba2's attention
    # (hd 64, timed in bf16), q_offset, non-causal over a ragged Skv, hd 64 /
    # 32 with ragged sequences, the reduced hd 16, granite's train shape
    # (GQA group 3, hd 64, timed in bf16), a ragged group 3 and a rank's
    # shard of qwen3's, of zamba2's shared block and musicgen's (timed in
    # bf16) and of granite's (timed in bf16) on the (2, 2) mesh.
    for shape, causal, off, timed in [
            ((4, 1024, 1024, 16, 8, 128), True, 0, (bf16, f32)),
            ((4, 1024, 1024, 32, 32, 64), True, 0, (bf16,)),  # zamba2 shared
            ((2, 256, 1024, 16, 8, 128), True, 768, ()),
            ((2, 128, 1601, 16, 8, 128), False, 0, ()),
            ((2, 200, 200, 8, 2, 64), True, 0, ()),
            ((1, 130, 130, 4, 4, 32), True, 0, ()),
            ((2, 40, 40, 4, 2, 16), True, 0, ()),
            ((2, 16, 48, 4, 2, 16), False, 0, ()),
            ((4, 1024, 1024, 24, 8, 64), True, 0, (bf16,)),
            ((2, 200, 200, 6, 2, 64), True, 0, ()),
            ((2, 1024, 1024, 8, 4, 128), True, 0, ()),    # qwen3, 2x2 shard
            # zamba2's and musicgen's 2x2 shard
            ((2, 1024, 1024, 16, 16, 64), True, 0, (bf16,)),
            ((2, 1024, 1024, 12, 4, 64), True, 0, (bf16,))]:  # granite, 2x2
        for dtype in (bf16, f32):
            results.append(flash_bwd_case(*shape, causal, off, dtype, gen,
                                          flush, dtype in timed, build))
    # llama-vision's train shapes, bf16: the non-causal cross-attention
    # (timed; a ragged last key block of 65), the causal self-attention,
    # and a 2x2 rank's shard of the cross-attention (timed).
    for shape, causal, timed in [((4, 1024, 1601, 64, 8, 128), False, True),
                                 ((4, 1024, 1024, 64, 8, 128), True, False),
                                 ((2, 1024, 1601, 32, 4, 128), False, True)]:
        results.append(flash_bwd_case(*shape, causal, 0, bf16, gen, flush,
                                      timed, build))
    for r in results:
        emit("kernels", **r)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    return results


# --------------------------------------------------------------- phase 4

def counted():
    """The kernel wrappers, by the names of the ``kernels`` line."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
    from repro_torch.kernels.ssd import ssd_chunk_bwd_cuda, ssd_chunk_cuda
    return {"rmsnorm": rmsnorm_cuda, "flash_attention": flash_attention_cuda,
            "ssd_chunk": ssd_chunk_cuda, "rmsnorm_bwd": rmsnorm_bwd_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "ssd_chunk_bwd": ssd_chunk_bwd_cuda}


VARIANT_COUNTED = ("flash_attention", "flash_attention_bwd")


def counts() -> dict:
    """Launches so far: each kernel's, and flash attention's forward and
    backward by variant (``flash_attention/wgmma``,
    ``flash_attention_bwd/wgmma`` and so on)."""
    fns = counted()
    return {**{k: f.launches for k, f in fns.items()},
            **{f"{name}/{k}": n for name in VARIANT_COUNTED
               for k, n in fns[name].variant_launches.items()}}


def reset_counts() -> None:
    fns = counted()
    for f in fns.values():
        f.launches = 0
    for name in VARIANT_COUNTED:
        fns[name].variant_launches = dict.fromkeys(
            fns[name].variant_launches, 0)


def tree_to(params, fn):
    """Apply ``fn`` to every tensor of a parameter tree (one level of
    sub-dicts: ``blocks``, ``shared``)."""
    return {k: ({n: fn(t) for n, t in v.items()} if isinstance(v, dict)
                else fn(v)) for k, v in params.items()}


def model_inputs(cfg, B: int, S: int, seed: int, device="cuda") -> dict:
    """One prefill's (or train step's) inputs, drawn from ``seed``: token
    ids, or audio's frame embeddings (the frontend stub's input, bf16 as
    ``batch_structs`` declares it); and a vlm's image embeddings (bf16)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def embeds(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(
            torch.bfloat16)
    out = {}
    if cfg.family == "audio":
        out["inputs_embeds"] = embeds(B, S, cfg.d_model)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                      device=device)
    if cfg.family == "vlm":
        out["img_embeds"] = embeds(B, cfg.n_image_tokens, cfg.d_model)
    return out


def with_inputs(cfg, batch: dict, seed: int, device="cuda") -> dict:
    """A (tokens, labels) batch with audio's frame embeddings in place of
    its tokens and a vlm's image embeddings added, drawn from ``seed``
    (``model_inputs``); other families' batches as they are."""
    if cfg.family not in ("audio", "vlm"):
        return batch
    B, S = batch["labels"].shape
    extra = model_inputs(cfg, B, S, seed, device)
    out = {k: v for k, v in batch.items()
           if k != "tokens" or "tokens" in extra}
    out.update({k: v for k, v in extra.items() if k != "tokens"})
    return out


def step_inputs(cfg, batch: int, seed: int) -> dict:
    """One decode step's input: a token id a sequence (numpy, from
    ``seed``), or audio's frame embedding."""
    if cfg.family == "audio":
        return {"inputs_embeds": model_inputs(cfg, batch, 1, seed)[
            "inputs_embeds"]}
    return {"tokens": torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, 1)))}


def open_gates(cfg, params, seed: int = 0):
    """A vlm's ``ca_gate`` set to 0.5 + 0.1 N(0, 1) (in place): the init's
    zeros (tanh(0) = 0) would hide every cross-attention error."""
    if cfg.family == "vlm":
        gate = params["cross"]["ca_gate"]
        gen = torch.Generator(device=gate.device).manual_seed(seed)
        gate.copy_(0.5 + 0.1 * torch.randn(gate.shape, generator=gen,
                                           device=gate.device))
    return params


def small_model_check(arch: str) -> None:
    """A reduced model with f32 weights: the card (kernels) against the CPU
    (plain versions) on the same weights and inputs; 40 tokens span two of
    the reduced SSM configs' 32-token chunks (audio: frame embeddings, so
    its first norm and products mix bf16 with f32; vlm: image embeddings
    and nonzero gates)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.transformer import forward, init_params
    cfg = reduced_config(arch)
    cpu = open_gates(cfg, tree_to(init_params(
        cfg, torch.Generator().manual_seed(0)), lambda t: t.float()))
    gpu = tree_to(cpu, lambda t: t.cuda())
    if cfg.family in ("audio", "vlm"):
        inputs = model_inputs(cfg, 2, 40, 0, device="cpu")
    else:
        inputs = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 40)))}
    with torch.inference_mode():
        want, _ = forward(cpu, cfg, remat="none", **inputs)
        got, _ = forward(gpu, cfg, remat="none",
                         **{k: v.cuda() for k, v in inputs.items()})
    err = float((got.cpu() - want).abs().max())
    ok = bool(torch.allclose(got.cpu(), want, atol=SMALL_F32_TOL,
                             rtol=SMALL_F32_TOL))
    emit("prefill", arch=arch, check="reduced model, card vs CPU (f32)",
         ok=ok, max_abs_err=err, tol=SMALL_F32_TOL)
    if not ok:
        raise AssertionError(f"reduced {arch} on the card differs from the "
                             f"CPU by {err}")


def cross_fired(cfg) -> int:
    """Layers whose cross-attention fires (every ``cross_attn_every``-th
    from 0): a vlm's n_ca when ``cross_attn_every`` divides n_layers."""
    return -(-cfg.n_layers // cfg.cross_attn_every) if cfg.family == "vlm" \
        else 0


def expected_per_forward(cfg) -> dict:
    """Kernel launches one prefill forward must make; every flash launch is
    the wgmma variant (bf16, hd 64 / 128).  moe and audio count as dense
    (moe's ``ffn_norm`` takes the place of the SwiGLU's); a vlm's cross
    layer adds its norm and its flash launch each time it fires."""
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        norms = L * (2 + 2 * cfg.qk_norm) + cross_fired(cfg) + 1
        flash, ssd = L + cross_fired(cfg), 0
    else:
        flash = -(-L // cfg.shared_attn_every) if cfg.family == "hybrid" else 0
        norms, ssd = L + 2 * flash + 1, L
    return {"rmsnorm": norms, "flash_attention": flash, "ssd_chunk": ssd,
            "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "ssd_chunk_bwd": 0,
            "flash_attention/wgmma": flash, "flash_attention/mma_sync": 0,
            "flash_attention/fma": 0, "flash_attention_bwd/wgmma": 0,
            "flash_attention_bwd/mma_sync": 0, "flash_attention_bwd/fma": 0}


def phase_prefill(cfg, params) -> dict:
    from repro_torch.serve.serve_step import make_prefill
    B, S, runs = 4, 1024, 3
    inputs = model_inputs(cfg, B, S, 0)
    prefill = make_prefill(cfg, "cuda")
    before = counts()
    with routing_log() as routes:     # warm-up run: the logits checked later
        logits = prefill(params, **inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        prefill(params, **inputs)
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
    return {"logits": logits, "routes": routes, "inputs": inputs, "ms": ms,
            "tokens_per_s": B * S / ms * 1e3, "launches": per_forward,
            "batch": B, "seq": S}


def held(got, want, atol: float = LOGITS_ATOL) -> tuple:
    """(within atol / LOGITS_RTOL, max abs error) of two logits, one
    sequence at a time (qwen3-moe's (4, 1024, 151936) logits in f32 would
    take 2.5 GB a copy beside its 61 GB of weights)."""
    ok, err = True, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        ok = ok and bool(torch.allclose(g, w, atol=atol, rtol=LOGITS_RTOL))
        err = max(err, float((g - w).abs().max()))
    return ok, err


@contextlib.contextmanager
def routing_log(replay=None, margins=None):
    """Inside: each MoE layer's top-k expert ids (sorted, (T, k)) of every
    ``route`` call, in call order; stays empty for the other families.
    With ``replay`` (another run's log of the same calls) each call takes
    the recorded experts instead of its own top-k, and weighs them by its
    own router probabilities, renormalised as ``route`` does.  A
    ``margins`` list gets each call's gap between every token's k-th and
    (k+1)-th router probability (T,), on the host."""
    from repro_torch.models import moe
    real, log = moe.route, []
    recorded = iter(replay) if replay is not None else None

    def spy(h, router, k):
        probs, top_p, top_i = real(h, router, k)
        if margins is not None:
            top = torch.topk(probs, k + 1, dim=-1).values
            margins.append((top[:, k - 1] - top[:, k]).cpu())
        if recorded is not None:
            top_i = next(recorded)
            top_p = probs.gather(-1, top_i)
            top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        log.append(top_i.sort(dim=-1).values)
        return probs, top_p, top_i
    moe.route = spy
    try:
        yield log
    finally:
        moe.route = real


def routing_agreement(a: list, b: list):
    """Share of (layer, token) pairs whose top-k sets match between two
    ``routing_log`` records of the same calls; None without MoE layers."""
    if not a:
        return None
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} routing calls against {len(b)}")
    same = sum(int((x == y).all(-1).sum()) for x, y in zip(a, b))
    return same / sum(x.shape[0] for x in a)


def first_flips(a: list, b: list) -> list:
    """The (call, token) route flips between two ``routing_log`` records of
    the same calls that no earlier flip reaches.  Within a step a token's
    input to a layer depends only on tokens at its own or a lower flat index
    (b-major) at earlier layers: its own sequence's earlier positions through
    causal attention, and the tokens before it in an expert's segment, which
    decide its capacity drop.  So a flip reaches every token at or after its
    index in every later call, and the pairs it reaches are its consequence,
    not the arithmetic's (one flip in an early layer moves a whole sequence's
    later tokens by O(1) and can flip hundreds of near-ties downstream).  A
    remat recompute's call repeats its forward's routes, so its flips are
    reached by the forward's.  Over decode steps, where rows do not share a
    sequence, the rule overstates what a flip reaches."""
    reach, sites = None, []
    for c, (x, y) in enumerate(zip(a, b)):
        idx = (x != y).any(-1).nonzero().flatten().tolist()
        sites += [(c, i) for i in idx if reach is None or i < reach]
        if idx:
            reach = idx[0] if reach is None else min(reach, idx[0])
    return sites


@contextlib.contextmanager
def plain_blocks(block_kv: int = 256, ssd_chunk: int = 128):
    """Inside: the plain flash forward takes its online softmax over
    ``block_kv``-key blocks instead of 1024, and the plain SSD runs over
    chunks of ``ssd_chunk`` steps instead of the model's 256 (the same
    function in exact arithmetic: the states carry across chunks); only
    the order of their f32 sums changes.  The plain path so run is the
    floor of a kernels-vs-plain comparison."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    ref, sref = fa_ops.flash_attention_ref, ssd_ops.ssd_ref
    fa_ops.flash_attention_ref = (
        lambda *a, **kw: ref(*a, **{**kw, "block_kv": block_kv}))
    ssd_ops.ssd_ref = lambda *a, **kw: sref(*a, **{**kw, "chunk": ssd_chunk})
    try:
        yield
    finally:
        fa_ops.flash_attention_ref, ssd_ops.ssd_ref = ref, sref


def route_gap(a: list, b: list) -> dict:
    """Two ``routing_log`` records of the same calls compared in both units
    of ``routes_held``: the agreement of their (call, token) pairs and the
    count of their first flips."""
    return {"agreement": routing_agreement(a, b),
            "first_flips": len(first_flips(a, b))}


def routes_held(got: dict, floor: dict, tokens: int, f32: bool) -> dict:
    """The routing limit of a MoE pair, from ``route_gap`` of the kernels'
    run (``got``) and of the floor's (``floor``) against the plain run.

    In bf16 the kernels may flip at most ROUTE_FACTOR times the (call,
    token) pairs that the floor flips, and never less than one token's
    routes in every call (1 / ``tokens`` of the pairs).  bf16 routes flip
    everywhere (15-30 % of the pairs) and their cascades overlap, so the
    pairs are a steady count (granite, 8 draws: the kernels 35.6-40.1
    thousand, the floor 19.5-21.8, examples/moe_route_flips_torch.py).

    In f32 a route flips only at a near-tie of the k-th and (k+1)-th router
    probability (gaps of 2e-8 to 9e-8 in the same draws), 0 or 1 a step,
    and each flip's cascade (``first_flips``) makes the pair count: one
    flip gave 2 to 164 pairs, another 290.  So there the kernels may make
    at most ROUTE_FACTOR times the floor's first flips, and never less than
    ROUTE_FACTOR."""
    r = {"floor_routing_agreement": floor["agreement"],
         "first_flips": got["first_flips"],
         "floor_first_flips": floor["first_flips"]}
    if f32:
        limit = ROUTE_FACTOR * max(floor["first_flips"], 1)
        return {**r, "route_unit": "first flips", "first_flips_limit": limit,
                "routes_ok": got["first_flips"] <= limit}
    limit = ROUTE_FACTOR * max(1 - floor["agreement"], 1 / tokens)
    return {**r, "route_unit": "pairs", "routing_agreement_limit": 1 - limit,
            "routes_ok": 1 - got["agreement"] <= limit}


def dtype_of(params) -> torch.dtype:
    """The type of a parameter tree's first tensor."""
    v = next(iter(params.values()))
    return next(iter(v.values())).dtype if isinstance(v, dict) else v.dtype


def pair_check(p, run, got=None, rk=None) -> dict:
    """``run(p, force_ref)`` -> logits, with kernels against plain versions
    on the weights ``p``, within LOGITS_ATOL / LOGITS_RTOL.  ``got`` and
    ``rk`` are the kernel run's logits and ``routing_log`` where the caller
    has them (the main path's own run); else the kernel run is made here.

    MoE routing is discrete: a last-bit change of a layer's input (bf16
    router logits round to 2^-8, so the k-th and (k+1)-th often tie) moves
    a token's k-th expert or a capacity drop, and that token's logits by
    far more than any tolerance.  So a MoE pair reports the routing
    agreement of the two runs (the share of (layer, token) pairs whose
    top-k sets match).  Where it is 1 the tolerance holds as it stands
    ("tolerance").  Where it is not ("replay"), two things must hold: the
    routes (``routes_held``: the kernels flip at most ROUTE_FACTOR times
    the routes of the floor, the plain path under ``plain_blocks``, on its
    own routing); and the values: the plain run, repeated on the kernel
    run's experts (``routing_log(replay=...)``), within the tolerance —
    the kernels' arithmetic against the plain versions' on the same
    discrete decisions."""
    if got is None:
        with routing_log() as rk:
            got = run(p, False)
    with routing_log() as rp:
        want = run(p, True)
    ok, err = held(got, want)
    r = {"ok": ok, "max_abs_err": err}
    agree = routing_agreement(rk, rp)
    if agree is not None:
        r.update(routing_agreement=agree, rule="tolerance")
        if agree < 1:
            del want
            with routing_log() as rf, plain_blocks():
                run(p, True)
            r.update(routes_held(route_gap(rk, rp), route_gap(rf, rp),
                                 rp[0].shape[0],
                                 dtype_of(p) == torch.float32))
            with routing_log(replay=rk):
                want = run(p, True)
            ok, err_replay = held(got, want)
            r.update(ok=ok and r["routes_ok"], rule="replay",
                     max_abs_err=err_replay, max_abs_err_own_routing=err)
    del got, want
    return r


def kernels_vs_plain(cfg, params, run, got=None, rk=None) -> dict:
    """``pair_check`` on the bf16 weights.  It must hold for the dense and
    moe families.  For ssm/hybrid it is reported only, and their f32 pairs
    (``check_f32``) must hold: with random bf16 weights the 38-48 Mamba2
    layers amplify a last-bit change of the SSD chunk's f32 sums (its order
    differs between the kernel and the einsums) into logit differences of
    order 1, which no right kernel can avoid (tests/test_torch_ssm.py pins
    this on the CPU with no kernel at all); in f32 the same change stays
    near 1e-3."""
    r = pair_check(params, run, got, rk)
    return {"ok": r["ok"] or cfg.family not in ("dense", "moe"), "bf16": r}


def check_prefill(cfg, params, pre) -> None:
    from repro_torch.serve.serve_step import make_prefill

    def run(p, force_ref):
        return make_prefill(cfg, "cuda", force_ref=force_ref)(
            p, **pre["inputs"])
    logits_max_abs = float(pre["logits"].abs().max())
    cmp = kernels_vs_plain(cfg, params, run, got=pre.pop("logits"),
                           rk=pre.pop("routes"))
    emit("prefill", arch=cfg.name, batch=pre["batch"], seq=pre["seq"],
         ms=pre["ms"], tokens_per_s=pre["tokens_per_s"],
         launches_per_forward=pre["launches"], **cmp,
         logits_max_abs=logits_max_abs,
         tol={"atol": LOGITS_ATOL, "rtol": LOGITS_RTOL},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if not cmp["ok"]:
        raise AssertionError(f"{cfg.name} prefill logits with kernels differ "
                             "from the plain-kernel forward")


# --------------------------------------------------------------- phase 5

def retrieval_client():
    """The port's own cache client over a knowledge corpus of 500 passages
    of 64 KB, as examples/serve_llm.py builds the reference's."""
    from repro_torch.core import CacheConfig, bundle_client
    from repro_torch.core.types import MB
    from repro_torch.storage import RemoteStore, make_dataset
    store = RemoteStore()
    store.add(make_dataset("knowledge", "flat_files", n_files=500,
                           small_file_size=64 * 1024))
    return bundle_client("igtcache", store, 16 * MB,
                         cfg=CacheConfig(min_share=2 * MB,
                                         rebalance_quantum=2 * MB))


def phase_serve(cfg, params) -> dict:
    from repro_torch.serve.engine import Request, ServingEngine
    n_req, max_new = 8, 16
    client = retrieval_client()
    eng = ServingEngine(params, cfg, batch=4, max_seq=512, device="cuda",
                        cache_engine=client, knowledge_dataset="knowledge")
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
    snap = client.snapshot()
    client.close()
    retrievals = sum(r.retrieved for r in done)
    # Decode reaches the flash kernel only through a vlm's cross-attention
    # (one q row over the image): once a step for each cross layer that
    # fires.
    ok = (len(done) == n_req and retrievals == 4 * n_req
          and all(len(r.output) == max_new for r in done)
          and launches["flash_attention"] == eng.steps * cross_fired(cfg)
          == launches["flash_attention/wgmma"])
    return {"engine": eng, "ok": ok, "requests": len(done),
            "tokens": sum(len(r.output) for r in done), "seconds": dt,
            "steps": eng.steps, "launches": launches,
            "retrievals": retrievals, "cache_reads": snap["hits"] + snap["misses"],
            "cache_hit_ratio": snap["hit_ratio"]}


def clone_state(state) -> dict:
    """A copy of every tensor of a decode state (decode_step updates them in
    place)."""
    return {k: v.clone() if torch.is_tensor(v) else v
            for k, v in state.items()}


def decode_run(cfg, state):
    """``run(p, force_ref)`` -> the logits of one decode step on a copy of
    ``state`` (decode_step updates it in place), for ``pair_check``: a
    token id a sequence, or audio's frame embedding."""
    from repro_torch.serve.serve_step import make_serve_step
    batch = state["ssd" if "ssd" in state else "k"].shape[1]
    feed = step_inputs(cfg, batch, 1)

    def run(p, force_ref):
        return make_serve_step(cfg, "cuda", force_ref=force_ref)(
            p, clone_state(state), **feed)[0]
    return run


def decode_step_check(cfg, params, state) -> dict:
    """One decode step with kernels against one with plain versions, each on
    its own copy of ``state`` (see ``kernels_vs_plain``); raises beyond the
    logits tolerance."""
    cmp = kernels_vs_plain(cfg, params, decode_run(cfg, state))
    if not cmp["ok"]:
        raise AssertionError(f"{cfg.name} decode logits with kernels differ "
                             f"from plain versions: {cmp}")
    return {"decode_" + k: v for k, v in cmp.items() if k != "ok"}


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
         **cmp, retrieval="on (the port's igtcache client)",
         retrievals=srv["retrievals"], cache_reads=srv["cache_reads"],
         cache_hit_ratio=srv["cache_hit_ratio"])
    if not srv["ok"]:
        raise AssertionError(f"{cfg.name} serving left requests unfinished")


def cut_depth(cfg, params, depth: int, clone: bool = False):
    """(cfg, params) cut to the first ``depth`` layers, with embed, final
    norm, head, a hybrid's shared block and a vlm's first
    ``depth // cross_attn_every`` cross layers; ``clone`` copies the cut
    layers (views otherwise)."""
    def first(tree, n):
        return {k: t[:n].clone() if clone else t[:n] for k, t in tree.items()}
    cut = dict(params, blocks=first(params["blocks"], depth))
    if cfg.family == "vlm":
        cut["cross"] = first(params["cross"], depth // cfg.cross_attn_every)
    return dataclasses.replace(cfg, n_layers=depth), cut


def cut_state(cfg, state, depth: int) -> dict:
    """A decode state cut (copied) to the first ``depth`` layers, and a
    vlm's image K/V to the cross layers among them."""
    n_ca = depth // cfg.cross_attn_every if cfg.family == "vlm" else 0
    return {k: (v[:depth].clone() if torch.is_tensor(v) else
                tuple(t[:n_ca].clone() for t in v) if k == "img_kv" else v)
            for k, v in state.items()}


def check_f32(cfg, params, inputs, state) -> None:
    """The f32 pairs: prefill on ``inputs`` and one decode step on
    ``state``, with the weights cast to f32, kernels against plain versions
    (``pair_check``).  ``params`` (the caller's only reference to the bf16
    weights) is emptied before the f32 copy is made.  A model in F32_DEPTH
    is cut first to its first layers, with embed, final norm and head, and
    ``state`` with it.  A vlm's state keeps its bf16 image K/V, so its
    decode step runs f32 queries over bf16 keys and values (cast to f32, as
    the reference computes them); audio's bf16 frame embeddings meet f32
    weights in its first norm and products."""
    depth = F32_DEPTH.get(cfg.name, cfg.n_layers)
    cut = dict(params)
    if depth < cfg.n_layers:
        state = cut_state(cfg, state, depth)
        cfg, cut = cut_depth(cfg, params, depth, clone=True)
    params.clear()
    torch.cuda.empty_cache()
    p32 = tree_to(cut, lambda t: t.float())
    del cut
    torch.cuda.empty_cache()
    from repro_torch.serve.serve_step import make_prefill
    prefill = pair_check(p32, lambda p, force_ref: make_prefill(
        cfg, "cuda", force_ref=force_ref)(p, **inputs))
    decode = pair_check(p32, decode_run(cfg, state))
    ok = prefill["ok"] and decode["ok"]
    emit("f32", arch=cfg.name, check="kernels vs plain, f32 weights",
         depth=depth, ok=ok, prefill_f32=prefill, decode_f32=decode,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del p32
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"{cfg.name} f32 logits at depth {depth} with "
                             f"kernels differ from plain versions")


def check_decode(cfg, params, steps: int = 8, img_embeds=None) -> dict:
    """For a model that is not served on the main path, or a vlm on an image
    state (``img_embeds``): ``steps`` decode steps from an empty state (its
    image K/V from ``img_embeds``), then one step with kernels against one
    with plain versions; returns the state."""
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.serve_step import make_serve_step
    state = init_decode_state(cfg, 4, 64, device="cuda", img_embeds=img_embeds,
                              params=None if img_embeds is None else params)
    step = make_serve_step(cfg, "cuda")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (4, steps))
    for t in range(steps):
        _, state = step(params, state, toks[:, t:t + 1])
    cmp = decode_step_check(cfg, params, state)
    emit("serve", arch=cfg.name, check="decode step after "
         f"{steps} steps" + (" on an image state" if img_embeds is not None
                             else "") + ", kernels vs plain", ok=True, **cmp)
    return state


# --------------------------------------------------------------- phase 6

TRAIN_ARCHS = ("qwen3-1.7b", "granite-moe-3b-a800m", "zamba2-1.2b",
               "mamba2-370m", AUDIO)
GRAD_ARCHS = (VLM,)          # loss and grads only, at GRAD_DEPTH
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 3       # timed steps, after one more
# A full-width step with kernels against the same step with plain versions:
# loss relative error, and each leaf's gradient by relative L2 error.  In
# bf16 the gradient bound is the larger of 2e-2 and twice the plain path's
# own floor, measured in the same run (``plain_floor``): with random weights
# the 28 layers amplify any last-bit change of the forward's bf16
# activations into gradient differences of 2-3 %, so a fixed 2e-2 would
# reject the plain path against itself (examples/train_grad_attribution_
# torch.py: each kernel alone moves them by about one floor).  A MoE step
# whose routing differs between the two runs is held to ``routes_held``,
# and compared, with its floor measured, with the plain runs on the kernel
# run's experts (``pair_check`` says why).  An ssm / hybrid step's floor
# also runs the plain SSD over 128-step chunks, and is measured in f32 too:
# the 38-48 Mamba2 layers amplify f32 rounding as well (zamba2's f32 prefill
# logits move by ~2e-3 between kernels and plain versions, qwen3's by 3e-6),
# so its f32 gradients and both losses are held within the larger of the
# fixed bound and twice the floor.  Where the bf16 floor's worst leaf is of
# order 1 (ORDER_ONE or more, five times the fixed 2e-2: the plain path's
# own gradients then differ by a tenth, and zamba2's / mamba2's floors of
# 0.35-0.58 would let twice them pass almost anything) the bf16 step is
# printed beside its floor (with ``ok``, whether it stays within twice it)
# and only its f32 step is held, as ssm / hybrid prefill logits are
# (``kernels_vs_plain``).
FLOOR_FACTOR = 2
# So an ssm / hybrid f32 step is also held to 1e-4 itself, on the model cut
# to its first F32_TRAIN_DEPTH layers (full width, zamba2's shared block
# included: one period of it); the plain f32 floor grows with depth, from
# ~1.5e-5 at one layer through ~4e-5 at six to 2.3-3.6e-4 at full depth
# (examples/train_f32_floor_torch.py).
F32_TRAIN_DEPTH = 6
TRAIN_TOL = {torch.bfloat16: {"loss": 1e-2, "grad": 2e-2},
             torch.float32: {"loss": 1e-4, "grad": 1e-4}}
ORDER_ONE = 0.1


def small_train_check(arch: str) -> None:
    """A reduced model with f32 weights: 4 steps of ``make_train_step`` on
    the card (kernels) against the CPU (plain versions), same weights and
    batches (audio: frame embeddings; vlm: image embeddings and nonzero
    gates); per-step loss within 1e-4, final params within 1e-4.

    AdamW's step is m / (sqrt(v) + eps) (bias-corrected), at the first step
    g / (|g| + eps): where sqrt(v) is itself within a few eps (a gradient
    element next to zero, one in ~10^4 on these reduced models) the step
    turns the last bits of the gradient into a change of any size.  So the
    params are held to 1e-4 on every element but those whose sqrt(v) in the
    CPU run is nonzero and at most ADAMW_NEAR_EPS x eps at some step; the
    line prints how many that excludes, where, and their gaps."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    cfg = reduced_config(arch)
    opt_cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=4)
    cpu = open_gates(cfg, tree_to(init_params(
        cfg, torch.Generator().manual_seed(0)), lambda t: t.float()))
    run = {}
    for dev in ("cpu", "cuda"):
        p = cpu if dev == "cpu" else tree_to(
            cpu, lambda t: t.to(dev, copy=True))
        run[dev] = [p, init_state(p), [],
                    make_train_step(cfg, opt_cfg, remat="full")]
    # each element's smallest nonzero AdamW denominator sqrt(v) on the CPU
    den = {path: torch.full(t.shape, float("inf"))
           for path, t in tree_leaves(cpu)}
    rng = np.random.default_rng(0)
    for step in range(1, 5):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 65)))
        cpu_batch = with_inputs(cfg, {"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]}, step, "cpu")
        for dev, r in run.items():
            batch = {k: v.to(dev) for k, v in cpu_batch.items()}
            r[0], r[1], m = r[3](r[0], r[1], batch)
            r[2].append(float(m["loss"]))
        for path, v in tree_leaves(run["cpu"][1].nu):
            d = (v / (1 - opt_cfg.b2 ** step)).sqrt()
            den[path] = torch.where(d > 0, torch.minimum(den[path], d),
                                    den[path])
    loss_err = max(abs(a - b) for a, b in zip(run["cpu"][2], run["cuda"][2]))
    err, close, worst, excluded = 0.0, True, None, []
    for (path, a), (_, b) in zip(tree_leaves(run["cuda"][0]),
                                 tree_leaves(run["cpu"][0])):
        gap = (a.cpu() - b).abs()
        skip = den[path] <= ADAMW_NEAR_EPS * opt_cfg.eps
        for i in skip.flatten().nonzero().flatten().tolist():
            excluded.append({"leaf": "/".join(path), "index": i,
                             "gap": float(gap.flatten()[i]),
                             "sqrt_v_min": float(den[path].flatten()[i])})
        held_gap = gap[~skip]
        if held_gap.numel() and float(held_gap.max()) > err:
            err, worst = float(held_gap.max()), "/".join(path)
        close = close and bool(
            (held_gap <= SMALL_F32_TOL * (1 + b.abs()[~skip])).all())
    ok = loss_err <= SMALL_F32_TOL and close
    emit("train", arch=cfg.name, check="reduced model, 4 steps, card vs "
         "CPU (f32)", ok=ok, losses=run["cuda"][2], max_loss_err=loss_err,
         max_param_err=err, worst_leaf=worst, params_within_tol=close,
         excluded_elements=len(excluded), excluded=excluded[:16],
         near_eps=ADAMW_NEAR_EPS * opt_cfg.eps, tol=SMALL_F32_TOL)
    if not ok:
        raise AssertionError(f"reduced training on the card differs from the "
                             f"CPU: loss {loss_err}, params {err} ({worst})")


def launcher_check() -> None:
    """``repro_torch.launch.train.main`` on the card (reduced model): 4 steps
    with checkpoints, then a resume to step 6 — the pipeline through the
    port's cache, the step, checkpoint, restore and ``PreemptionGuard``."""
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.train.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt") as d:
        args = ["--arch", TRAIN_ARCHS[0], "--reduced", "--device", "cuda",
                "--batch", "4", "--seq", "128", "--cache-mb", "64",
                "--ckpt-dir", d, "--ckpt-every", "2", "--log-every", "2"]
        t0 = time.perf_counter()
        rcs = [launch_train.main(args + ["--steps", "4"]),
               launch_train.main(args + ["--steps", "6", "--resume"])]
        latest = CheckpointManager(d).latest_step()
    ok = rcs == [0, 0] and latest == 6
    emit("train", arch=TRAIN_ARCHS[0], check="launcher, reduced, 4 steps then "
         "resumed to 6", ok=ok, rcs=rcs, latest_step=latest,
         seconds=time.perf_counter() - t0)
    if not ok:
        raise AssertionError(f"launcher run failed: rcs {rcs}, latest "
                             f"checkpoint {latest}")


def expected_per_train_step(cfg) -> dict:
    """Kernel launches of one train step (or loss and grads: AdamW launches
    none of these) under remat="full": every layer's forward runs twice (the
    step, then the recompute), the final norm once; one backward each.  A
    layer's norms: dense / moe / audio / vlm 2 (+ 2 q/k norms), a Mamba2
    layer 1 (its gated norm is plain torch), the hybrid's shared block 2
    each time it fires (every ``shared_attn_every``-th layer, with its
    attention), a vlm's cross layer 1 each time it fires (with its
    non-causal attention).  Every flash launch, forward and backward, is the
    ``wgmma`` variant (bf16, hd 64 / 128)."""
    L = cfg.n_layers
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        norms = L * (2 + 2 * cfg.qk_norm) + cross_fired(cfg)
        flash, ssd = L + cross_fired(cfg), 0
    else:
        flash = -(-L // cfg.shared_attn_every) if cfg.family == "hybrid" else 0
        norms, ssd = L + 2 * flash, L
    return {"rmsnorm": 2 * norms + 1, "flash_attention": 2 * flash,
            "ssd_chunk": 2 * ssd, "rmsnorm_bwd": norms + 1,
            "flash_attention_bwd": flash, "ssd_chunk_bwd": ssd,
            "flash_attention/wgmma": 2 * flash,
            "flash_attention/mma_sync": 0, "flash_attention/fma": 0,
            "flash_attention_bwd/wgmma": flash,
            "flash_attention_bwd/mma_sync": 0, "flash_attention_bwd/fma": 0}


def train_batch(cfg, batch_np, seed: int) -> dict:
    """A pipeline batch on the card; audio trains on frame embeddings drawn
    from ``seed`` in place of the token ids (the frontend stub's input, as
    ``batch_structs`` declares it), against the pipeline's labels; a vlm
    gets image embeddings from ``seed``."""
    from repro_torch.launch.train import to_device
    return with_inputs(cfg, to_device(batch_np, "cuda"), 100 + seed)


def phase_train(cfg, params) -> dict:
    """The main path: ``make_train_step`` (remat="full", dense loss, AdamW)
    on batches of TRAIN_B x TRAIN_S tokens from the launcher's
    ``CachedTokenPipeline`` over the port's cache (``train_batch``), one
    warm-up step and TRAIN_STEPS timed ones; launches per step checked."""
    from repro_torch.launch.train import build_pipeline
    from repro_torch.storage import RemoteStore
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    steps = TRAIN_STEPS + 1
    pipe, client = build_pipeline(RemoteStore(), cfg.vocab, batch=TRAIN_B,
                                  seq=TRAIN_S, steps=steps, cache_mb=256,
                                  cache_bundle="igtcache")
    opt_state = init_state(params)
    step = make_train_step(cfg, AdamWConfig(total_steps=steps), remat="full")
    it = pipe.batches(epochs=1000)
    draws = iter(range(steps))
    before = counts()
    batch = train_batch(cfg, next(it), next(draws))
    params, opt_state, m = step(params, opt_state, batch)  # warm-up step
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data_s = 0.0                         # host time drawing the next batch
    for _ in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        batch = train_batch(cfg, next(it), next(draws))
        data_s += time.perf_counter() - t1
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    per_step = {k: (v - before[k]) / steps for k, v in counts().items()}
    stats = pipe.stats
    pipe.close()
    client.close()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if per_step != expected_per_train_step(cfg):
        raise AssertionError(f"{cfg.name} train step launched {per_step}, "
                             f"expected {expected_per_train_step(cfg)}")
    del opt_state
    return {"batch": batch, "ms": ms, "losses": losses,
            "data_ms": data_s / TRAIN_STEPS * 1e3,
            "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
            "launches": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cache_hit_ratio": stats.hit_ratio, "cache_hits": stats.cache_hits,
            "cache_misses": stats.cache_misses,
            "prefetch_completed": stats.prefetch_completed}


def train_step_flops(cfg, B, S) -> float:
    """Useful FLOPs of one train step under remat="full": the weight
    products 6 N T plus the recomputed forward 2 N T (N the matrix
    parameters a token meets, the tied head counted once; in a MoE layer the
    router and the token's top-k experts, not the capacity buffer's padding
    rows), attention's two products over the causal pairs, forward twice
    and backward (2.5x) once, and a Mamba2 layer's SSD chunk (``ssd_work``)
    forward twice and backward (``ssd_bwd_work``) once.  A Mamba2 layer's
    weights are in_proj d x (2 d_in + 2 n + nh) and out_proj d_in x d; the
    hybrid's shared attention / MLP block counts once each time it fires,
    and so does a vlm's cross layer (q and o products over the tokens,
    attention over the image; its K and V products over the image
    embeddings, outside the checkpointed layers, 6 N a row)."""
    d, L = cfg.d_model, cfg.n_layers
    T = B * S
    qkv = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    attn_block = qkv + cfg.n_heads * cfg.hd * d + 3 * d * cfg.d_ff
    attn = (2 + 2.5) * attention_work(B, S, S, cfg.n_heads, cfg.hd, True, 0)
    head = 6 * d * cfg.vocab * T
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        if cfg.family == "moe":
            attn_block += (d * cfg.n_experts
                           + 3 * d * cfg.d_ff * (cfg.top_k - 1))
        flops = 8 * L * attn_block * T + head + L * attn
        if cfg.family == "vlm":
            n_img = cfg.n_image_tokens
            qo = 2 * d * cfg.n_heads * cfg.hd
            kv = 2 * d * cfg.n_kv_heads * cfg.hd
            cross = (8 * qo * T + 6 * kv * B * n_img + (2 + 2.5)
                     * attention_work(B, S, n_img, cfg.n_heads, cfg.hd,
                                      False, 0))
            flops += cross_fired(cfg) * cross
        return flops
    from repro_torch.models.ssm import ssm_dims
    d_in, nh, n, _ = ssm_dims(cfg)
    chunk = cfg.ssm_chunk
    shape = (B, -(-S // chunk), chunk, nh, cfg.ssm_head_dim, n)
    ssd = 2 * ssd_work(*shape)[0] + ssd_bwd_work(*shape)[0]
    mamba = d * (2 * d_in + 2 * n + nh) + d_in * d
    flops = 8 * L * mamba * T + head + L * ssd
    if cfg.family == "hybrid":
        calls = -(-L // cfg.shared_attn_every)
        flops += calls * (8 * attn_block * T + attn)
    return flops


def grad_gap(got, want) -> tuple:
    """(loss relative error, {leaf: relative L2 error}) of two
    ``make_value_and_grad`` results."""
    from repro_torch.models.params import tree_leaves
    ref = dict(tree_leaves(want[1]))
    errs = {"/".join(path): rel_l2(g, ref[path])
            for path, g in tree_leaves(got[1])}
    return float((got[0] - want[0]).abs() / want[0].abs()), errs


def plain_floor(cfg, params, batch):
    """Loss and gradients of the plain path under ``plain_blocks``."""
    from repro_torch.train.train_step import make_value_and_grad
    with plain_blocks():
        return make_value_and_grad(cfg, remat="full", force_ref=True)(
            params, batch)


def grad_pair(cfg, p, batch, dtype) -> dict:
    """One loss and its gradients with kernels against the same with plain
    versions (``force_ref``), from the weights ``p`` (of ``dtype``) and
    ``batch``, under TRAIN_TOL and the floors (``check_train`` says
    which)."""
    from repro_torch.train.train_step import make_value_and_grad
    plain_step = make_value_and_grad(cfg, remat="full", force_ref=True)
    ssm = cfg.family in ("ssm", "hybrid")
    with routing_log() as rk:
        kern = make_value_and_grad(cfg, remat="full")(p, batch)
    with routing_log() as rp:
        plain = plain_step(p, batch)
    agree = routing_agreement(rk, rp)
    replay = rk if agree is not None else None
    r = {}
    if agree is not None:
        r.update(routing_agreement=agree, rule="tolerance")
        if agree < 1:
            loss_rel, errs = grad_gap(kern, plain)
            r.update(rule="replay", loss_rel_err_own_routing=loss_rel,
                     worst_grad_rel_l2_own_routing=max(errs.values()))
            del plain
            with routing_log() as rf:
                plain_floor(cfg, p, batch)
            r.update(routes_held(route_gap(rk, rp), route_gap(rf, rp),
                                 rp[0].shape[0], dtype == torch.float32))
            del rf
            with routing_log(replay=replay):
                plain = plain_step(p, batch)
    loss_rel, errs = grad_gap(kern, plain)
    tol = dict(TRAIN_TOL[dtype])
    if dtype == torch.float32 and "inputs_embeds" in batch:
        # Audio's frame embeddings are bf16 (as in the reference), so under
        # f32 weights layer 0's attention norm returns bf16 and its
        # gradient arrives rounded to bf16: a last-bit change upstream
        # moves that one row of ``attn_norm``'s gradient by bf16 steps,
        # 0.5-0.9e-4 of the leaf between two plain runs at any depth
        # (examples/train_f32_floor_torch.py).  That row is held at the
        # bf16 gradient bound, the leaf's other rows with the rest.
        k0, p0 = (t[1]["blocks"]["attn_norm"] for t in (kern, plain))
        errs["blocks/attn_norm"] = rel_l2(k0[1:], p0[1:])
        r["bf16_cotangent_rows"] = {"blocks/attn_norm[0]": rel_l2(k0[0],
                                                                 p0[0])}
        r["bf16_cotangent_ok"] = (r["bf16_cotangent_rows"][
            "blocks/attn_norm[0]"] <= TRAIN_TOL[torch.bfloat16]["grad"])
    worst = max(errs, key=errs.get)
    r.update({"loss_kernels": float(kern[0]),
              "loss_plain": float(plain[0]), "loss_rel_err": loss_rel,
              "worst_grad_rel_l2": errs[worst], "worst_leaf": worst,
              "embed_grad_rel_l2": errs["embed"],
              "median_grad_rel_l2": float(np.median(list(errs.values())))})
    if cfg.family == "vlm":
        r["cross_grad_rel_l2"] = {k: v for k, v in errs.items()
                                  if k.startswith("cross/")}
    del kern
    if dtype == torch.bfloat16 or ssm:
        with routing_log(replay=replay):
            floor_run = plain_floor(cfg, p, batch)
        floor_loss, floor = grad_gap(floor_run, plain)
        del floor_run
        r.update(floor_worst_grad_rel_l2=max(floor.values()),
                 floor_median_grad_rel_l2=float(np.median(
                     list(floor.values()))),
                 floor_loss_rel_err=floor_loss)
        tol["grad"] = max(tol["grad"],
                          FLOOR_FACTOR * r["floor_worst_grad_rel_l2"])
        if ssm:
            tol["loss"] = max(tol["loss"], FLOOR_FACTOR * floor_loss)
    r["ok"] = (loss_rel <= tol["loss"] and errs[worst] <= tol["grad"]
               and r.get("routes_ok", True)
               and r.get("bf16_cotangent_ok", True))
    r["tol"] = tol
    if (ssm and dtype == torch.bfloat16
            and r["floor_worst_grad_rel_l2"] >= ORDER_ONE):
        r.update(rule="reported: floor of order 1", held=False)
    return r


def check_train(cfg, params, tr) -> None:
    """One step's loss and gradients with kernels against the same step with
    plain versions (``force_ref``), from the same weights and batch: in bf16
    and with the weights cast to f32 (TRAIN_TOL).  A MoE step reports its
    routing agreement; where it is below 1 its routes are held to
    ``routes_held`` (the floor on its own routing), and the plain step is
    repeated on the kernel step's experts, where the bf16 floor is measured
    too (``pair_check`` says why)."""
    from repro_torch.train.train_step import make_value_and_grad
    ssm = cfg.family in ("ssm", "hybrid")
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        p = params if dtype == torch.bfloat16 else tree_to(
            params, lambda t: t.float())
        out[str(dtype)[6:]] = grad_pair(cfg, p, tr["batch"], dtype)
        del p
        torch.cuda.empty_cache()
    if ssm:
        c, cut = cut_depth(cfg, params, F32_TRAIN_DEPTH)
        p = tree_to(cut, lambda t: t.float())
        loss_rel, errs = grad_gap(
            make_value_and_grad(c, remat="full")(p, tr["batch"]),
            make_value_and_grad(c, remat="full", force_ref=True)(
                p, tr["batch"]))
        worst = max(errs, key=errs.get)
        tol = TRAIN_TOL[torch.float32]
        out[f"float32_depth{F32_TRAIN_DEPTH}"] = {
            "loss_rel_err": loss_rel, "worst_grad_rel_l2": errs[worst],
            "worst_leaf": worst, "tol": tol,
            "ok": loss_rel <= tol["loss"] and errs[worst] <= tol["grad"]}
        del p, cut
        torch.cuda.empty_cache()
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    emit("train", arch=cfg.name, batch=TRAIN_B, seq=TRAIN_S, remat="full",
         loss="dense", ms_per_step=tr["ms"], tokens_per_s=tr["tokens_per_s"],
         data_ms_per_step=tr["data_ms"],
         step_tflop=flops / 1e12,
         achieved_tflops=flops / tr["ms"] / 1e9,
         bound_ms_bf16_peak=flops / PEAK_FLOPS[torch.bfloat16] * 1e3,
         losses=tr["losses"], peak_mem_gb=tr["peak_mem_gb"],
         launches_per_step=tr["launches"],
         cache_hit_ratio=tr["cache_hit_ratio"],
         cache_hits=tr["cache_hits"], cache_misses=tr["cache_misses"],
         prefetch_completed=tr["prefetch_completed"],
         kernels_vs_plain=out)
    bad = [k for k, v in out.items() if not v["ok"] and v.get("held", True)]
    if bad:
        raise AssertionError(f"{cfg.name} train step with kernels differs "
                             f"from plain versions in {bad}: {out}")


def random_batch(cfg) -> dict:
    """A TRAIN_B x TRAIN_S batch of random tokens (seed 0) on the card; audio
    on frame embeddings, a vlm with image embeddings (``model_inputs``)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), generator=gen,
                         device="cuda")
    return with_inputs(cfg, {"tokens": toks[:, :-1].contiguous(),
                             "labels": toks[:, 1:].contiguous()}, 1)


def profile_train(cfg, params, batch) -> None:
    """A full-width train step (not on the main path's counts), warm, then
    its two halves traced apart: loss and grads, and the AdamW update (the
    step's device time is their sum; a trace of the whole step as well
    cost ~6-20 s of host a model and no check reads it)."""
    from repro_torch.train.optimizer import (AdamWConfig, apply_updates,
                                             init_state)
    from repro_torch.train.train_step import (make_train_step,
                                              make_value_and_grad)
    opt_cfg = AdamWConfig()
    opt_state = init_state(params)
    make_train_step(cfg, opt_cfg, remat="full")(params, opt_state, batch)
    torch.cuda.synchronize()
    value_and_grad = make_value_and_grad(cfg, remat="full")
    traced = {}
    profile_once(cfg.name, "train_step/loss_and_grads",
                 lambda: traced.update(out=value_and_grad(params, batch)))
    _, grads = traced.pop("out")
    profile_once(cfg.name, "train_step/adamw",
                 lambda: apply_updates(params, grads, opt_state, opt_cfg))
    del opt_state, grads


def run_train(arch: str) -> dict:
    """One model's train path, counted from 0 as each model's serving path
    is; then its checks and profile."""
    cfg, params = init_model(arch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # the train path starts here
    tr = phase_train(cfg, params)
    launches = counts()                  # ... and ends here
    check_train(cfg, params, tr)
    profile_train(cfg, params, tr["batch"])
    del params, tr["batch"]
    torch.cuda.empty_cache()
    return {"launches": launches, "per_train_step": tr["launches"],
            "ms": tr["ms"]}


def run_grads(arch: str) -> dict:
    """A model trained on one card only as far as its loss and grads
    (llama-vision: its first GRAD_DEPTH layers, one cross layer among them;
    a full step's AdamW state would not fit): two calls of
    ``make_value_and_grad`` (remat "full", dense loss) on a TRAIN_B x
    TRAIN_S batch from the launcher's ``CachedTokenPipeline`` with random
    image embeddings, counted from 0 as a train path, the second timed; then
    one call with kernels against plain versions in bf16 (``grad_pair``:
    its own kernel call, as the three grads trees and the params take ~52
    GB)."""
    from repro_torch.launch.train import build_pipeline
    from repro_torch.storage import RemoteStore
    from repro_torch.train.train_step import make_value_and_grad
    cfg, params = init_model(arch, depth=GRAD_DEPTH)
    pipe, client = build_pipeline(RemoteStore(), cfg.vocab, batch=TRAIN_B,
                                  seq=TRAIN_S, steps=1, cache_mb=256,
                                  cache_bundle="igtcache")
    batch = train_batch(cfg, next(pipe.batches(epochs=1)), 0)
    pipe.close()
    client.close()
    value_and_grad = make_value_and_grad(cfg, remat="full")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # the train path starts here
    loss0, _ = value_and_grad(params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _ = value_and_grad(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = counts()                  # ... and ends here
    per_call = {k: v / 2 for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    del _
    r = grad_pair(cfg, params, batch, torch.bfloat16)
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_S)
    ok = (r["ok"] and bool(torch.isfinite(loss0))
          and per_call == expected_per_train_step(cfg))
    emit("train", arch=cfg.name, check=f"loss and grads, first {GRAD_DEPTH} "
         "layers, kernels vs plain (bf16)", depth=GRAD_DEPTH, batch=TRAIN_B,
         seq=TRAIN_S, remat="full", loss="dense", ms_per_loss_and_grads=ms,
         tokens_per_s=TRAIN_B * TRAIN_S / ms * 1e3, tflop=flops / 1e12,
         achieved_tflops=flops / ms / 1e9, peak_mem_gb=peak,
         launches_per_call=per_call,
         expected_per_call=expected_per_train_step(cfg), ok=ok,
         kernels_vs_plain={"bfloat16": r})
    if not ok:
        raise AssertionError(f"{cfg.name} loss and grads with kernels: {r}, "
                             f"launches {per_call}")
    del params, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "per_train_step": per_call}


# --------------------------------------------------------------- phase 6c

UNIFIED = "unified/qwen3-1.7b"
UNIFIED_STEPS = 4                 # train steps before serving, and after
UNIFIED_CACHE_MB, UNIFIED_PROCS = 48, 2
UNIFIED_TIERS = "ram_mb=16&disk_mb=256"
UNIFIED_ARENA_MIN = 4 << 20       # many times a batch's demand misses


def shm_free_bytes() -> int:
    import shutil
    return shutil.disk_usage("/dev/shm").free


def unified_arena_bytes() -> int:
    """The process driver's default demand-byte arena (one shared-memory
    block) where ``/dev/shm`` holds it, else half of its free bytes; raises
    below ``UNIFIED_ARENA_MIN`` (no fallback to pickled replies)."""
    from repro_torch.core.procdriver import DEFAULT_ARENA_BYTES
    arena = min(DEFAULT_ARENA_BYTES, shm_free_bytes() // 2 >> 20 << 20)
    if arena < UNIFIED_ARENA_MIN:
        raise AssertionError(f"/dev/shm has {shm_free_bytes()} bytes free: "
                             f"no room for a {UNIFIED_ARENA_MIN}-byte arena")
    return arena


def unified_datasets() -> list:
    """The launcher's token corpus, sized as ``build_pipeline`` sizes it
    for the path's steps (8 shards of 8 MB), and ``retrieval_client``'s
    knowledge set (500 passages of 64 KB)."""
    from repro_torch.core.types import MB
    from repro_torch.data.pipeline import make_token_dataset
    from repro_torch.launch.train import N_SHARDS
    from repro_torch.storage import make_dataset
    shard = max(8 * MB, TRAIN_B * (TRAIN_S + 1) * 4 * 2 * UNIFIED_STEPS
                // N_SHARDS)
    return [make_token_dataset("train_corpus", N_SHARDS, shard),
            make_dataset("knowledge", "flat_files", n_files=500,
                         small_file_size=64 * 1024)]


def unified_cache_cfg():
    from repro_torch.core import CacheConfig
    from repro_torch.core.types import MB
    return CacheConfig(min_share=2 * MB, rebalance_quantum=2 * MB)


def plain_batches(vocab: int, n: int) -> list:
    """The pipeline's first ``n`` batches, same seed, over a plain
    ``RemoteStore`` through an in-process ``bundle_client``."""
    from repro_torch.core import bundle_client
    from repro_torch.core.types import MB
    from repro_torch.data.pipeline import CachedTokenPipeline
    from repro_torch.storage import RemoteStore
    store = RemoteStore()
    store.add(unified_datasets()[0])
    client = bundle_client("igtcache", store, UNIFIED_CACHE_MB * MB,
                           cfg=unified_cache_cfg(), executor="sim")
    pipe = CachedTokenPipeline(store, client, "train_corpus", seq_len=TRAIN_S,
                               batch=TRAIN_B, vocab=vocab)
    it = pipe.batches(epochs=1000)
    out = [next(it) for _ in range(n)]
    pipe.close()
    client.close()
    return out


def run_unified(paths: dict) -> dict:
    """qwen3-1.7b at full width and depth (bf16, seed 0) trains and serves
    through ONE process-driver cache client over a ``tiered+sim://`` store:
    two shard worker processes, the process executor, demand bytes through
    the shared-memory arena (``fetch_bytes``: without it no byte would cross
    the arena).  4 train steps fed by ``CachedTokenPipeline``, a
    ``ServingEngine`` answering 8 requests of 16 tokens with 4 retrievals
    each, 4 more train steps; counted from 0 as a path.  Checks: (a) the 8
    batches equal the plain pipeline's and every retrieved passage equals
    a plain store's bytes; (b) launches per train step and per decode step
    equal those of this run's ``train/qwen3-1.7b`` and qwen3 serve paths;
    (c) 8 requests done, 32 retrievals; (d) no arena spill, no worker kill
    or respawn, and after ``close`` every worker exited 0, no child process
    is left and the arena's segment is gone."""
    import multiprocessing
    import os
    import tempfile
    from repro_torch.core import open_cache
    from repro_torch.core.types import MB, block_key
    from repro_torch.data.pipeline import CachedTokenPipeline
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.storage import RemoteStore, open_store
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    arch = UNIFIED.split("/", 1)[1]
    cfg, params = init_model(arch)
    spill = tempfile.mkdtemp(prefix="igt-spill-")
    store = open_store(f"tiered+sim://default?{UNIFIED_TIERS}"
                       f"&spill_dir={spill}")
    held = {}
    for ds in unified_datasets():
        store.add(ds)
        held[ds.name] = sum(f.size for f in ds.files)
    arena, shm_free = unified_arena_bytes(), shm_free_bytes()
    t0 = time.perf_counter()
    client = open_cache(store, UNIFIED_CACHE_MB * MB, driver="process",
                        n_procs=UNIFIED_PROCS, arena_bytes=arena,
                        fetch_bytes=True, cfg=unified_cache_cfg())
    open_s = time.perf_counter() - t0
    engine = client.engine
    procs = [ch.proc for ch in engine._channels]
    start_method = engine._spawn["ctx"].get_start_method()
    emit("unified", arch=cfg.name, check="set-up", store=type(store).__name__,
         tiers=UNIFIED_TIERS, spill_dir=spill, dataset_bytes=held,
         cache_bytes=UNIFIED_CACHE_MB * MB, workers=len(procs),
         worker_pids=[w["pid"] for w in engine.worker_info],
         start_method=start_method, executor=type(client.executor).__name__,
         arena_bytes=arena, dev_shm_free_bytes=shm_free,
         open_cache_s=open_s)
    retrieved = []            # (path, size, bytes, hits, blocks, ms)
    read = client.read

    def logged_read(*a, **kw):
        t1 = time.perf_counter()
        r = read(*a, **kw)
        ms = (time.perf_counter() - t1) * 1e3
        retrieved.append((a[0], a[2], bytes(r.data),
                          sum(b.hit for b in r.blocks), len(r.blocks), ms))
        return r
    client.read = logged_read
    steps = 2 * UNIFIED_STEPS
    pipe = CachedTokenPipeline(store, client, "train_corpus",
                               seq_len=TRAIN_S, batch=TRAIN_B,
                               vocab=cfg.vocab)
    it = pipe.batches(epochs=1000)
    opt_state = init_state(params)
    step = make_train_step(cfg, AdamWConfig(total_steps=steps), remat="full")
    batches, step_ms, draw_ms, losses = [], [], [], []
    train_launches = {}

    def train(n):
        nonlocal params, opt_state
        for _ in range(n):
            before = counts()
            t1 = time.perf_counter()
            b = next(it)
            draw_ms.append((time.perf_counter() - t1) * 1e3)
            batches.append({k: v.copy() for k, v in b.items()})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt_state, m = step(params, opt_state,
                                        train_batch(cfg, b, len(batches)))
            losses.append(float(m["loss"]))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            for k, v in counts().items():
                train_launches[k] = train_launches.get(k, 0) + v - before[k]

    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # the unified path starts here
    train(UNIFIED_STEPS)
    n_req, max_new = 8, 16
    eng = ServingEngine(params, cfg, batch=4, max_seq=512, device="cuda",
                        cache_engine=client, knowledge_dataset="knowledge")
    rng = np.random.default_rng(0)
    for rid in range(n_req):
        prompt = rng.integers(0, cfg.vocab, rng.integers(16, 65))
        eng.submit(Request(rid, prompt, max_new=max_new))
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = {k: v - before[k] for k, v in counts().items()}
    decode_steps = eng.steps
    train(UNIFIED_STEPS)
    launches = counts()                  # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    pipe.close()
    pipe_stats = dataclasses.asdict(pipe.stats)
    snap = client.snapshot()
    by_dataset = {"train_corpus": pipe.stats.hit_ratio,
                  "knowledge": sum(r[3] for r in retrieved)
                  / max(1, sum(r[4] for r in retrieved))}
    spills = engine.arena_spills()
    faults = engine.fault_stats()
    demand_fetches = client.executor.stats.demand_fetches
    segment = os.path.join("/dev/shm", engine.arena.name.lstrip("/"))
    client.close()
    exitcodes = [p.exitcode for p in procs]
    children = [p.name for p in multiprocessing.active_children()]
    segment_left = os.path.exists(segment)
    del opt_state, eng, params
    torch.cuda.empty_cache()
    # (a) the tiers and the workers change no byte
    want = plain_batches(cfg.vocab, steps)
    batches_equal = len(batches) == len(want) == steps and all(
        sorted(g) == sorted(w) and all(
            g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
            for k in w) for g, w in zip(batches, want))
    plain = RemoteStore()
    plain.add(unified_datasets()[1])
    passages_equal = len(retrieved) > 0 and all(
        data == bytes(plain.fetch_range(block_key(path, 0), 0, size))
        for path, size, data, _, _, _ in retrieved)
    # (b) launches against this run's qwen3 train and serve paths
    per_train = {k: v / steps for k, v in train_launches.items()}
    per_decode = {k: v / max(1, decode_steps)
                  for k, v in serve_launches.items()}
    ref_train = paths[f"train/{arch}"]["per_train_step"]
    ref_decode = paths[arch]["per_decode_step"]
    # (c) serving completes
    retrievals = sum(r.retrieved for r in done)
    checks = {
        "a_batches_equal": batches_equal, "a_passages_equal": passages_equal,
        "b_train_launches": per_train == ref_train
        == expected_per_train_step(cfg),
        "b_decode_launches": per_decode == ref_decode,
        "c_serving": len(done) == n_req and retrievals == 4 * n_req
        and all(len(r.output) == max_new for r in done),
        "d_no_arena_spill": spills == 0,
        "d_no_kill_or_respawn": not faults["events"]
        and faults["restarts"] == 0,
        "d_workers_exited_0": exitcodes == [0] * len(procs),
        "d_no_children": children == [],
        "d_arena_segment_gone": not segment_left,
        "losses_finite": bool(np.all(np.isfinite(losses))),
    }
    tiers = snap["store"]["tiers"]
    ms_train = float(np.mean(step_ms[1:]))     # the first one warms up
    out = {
        "arch": cfg.name, "path": UNIFIED, "ok": all(checks.values()),
        "checks": checks, "steps": steps, "batch": TRAIN_B, "seq": TRAIN_S,
        "ms_per_train_step": ms_train,
        "ms_per_train_step_each": step_ms,
        "train_qwen3_ms_per_train_step": paths[f"train/{arch}"]["ms"],
        "ms_per_decode_step": serve_s / max(1, decode_steps) * 1e3,
        "serve_qwen3_ms_per_decode_step": paths[arch]["ms_per_decode_step"],
        "decode_steps": decode_steps, "requests": len(done),
        "retrievals": retrievals,
        "host_ms_per_retrieval": float(np.mean([r[5] for r in retrieved])),
        "retrieval_ms_per_decode_step": sum(r[5] for r in retrieved)
        / max(1, decode_steps),
        "host_ms_per_batch_draw": float(np.mean(draw_ms)),
        "host_ms_per_batch_draw_each": draw_ms, "losses": losses,
        "cache_hit_ratio": snap["hit_ratio"],
        "cache_hits": snap["hits"], "cache_misses": snap["misses"],
        "hit_ratio_by_dataset": by_dataset,
        "pipeline": pipe_stats,
        "tiers": {k: tiers[k] for k in ("ram_hits", "disk_hits", "spills",
                                        "remote_bytes", "pass_through",
                                        "misses")},
        "tier_counters_of": "the client process's TieredStore (each worker "
                            "holds its own copy)",
        "workers": len(procs), "start_method": start_method,
        "arena_bytes": arena, "arena_spills": spills,
        "demand_fetches": demand_fetches, "worker_exitcodes": exitcodes,
        "per_train_step": per_train, "per_decode_step": per_decode,
        "peak_mem_gb": peak}
    emit("unified", **out)
    if not out["ok"]:
        raise AssertionError(f"{UNIFIED} failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {"launches": launches, "per_train_step": per_train,
            "per_decode_step": per_decode}


def phase_cache() -> dict:
    """Host phase on the card's machine (no GPU): two walkthroughs of
    examples/quickstart_torch.py, each checking itself: a ``CacheDaemon``
    over two shard worker processes with two ``cache://`` sessions (the
    second hits every block the first read, with no demand fetch), and a
    ``tiered+mock-s3://`` stack (every payload equals ``mock_object_bytes``;
    pass 2 from the tiers, ``remote_bytes`` frozen at the pass-1 total)."""
    import multiprocessing
    qs = load_example("quickstart_torch")
    t0 = time.perf_counter()
    daemon = qs.daemon_walkthrough()
    t1 = time.perf_counter()
    tiered = qs.tiered_s3_walkthrough()
    t2 = time.perf_counter()
    children = [p.name for p in multiprocessing.active_children()]
    out = {"ok": children == [], "daemon": daemon, "tiered": tiered,
           "daemon_s": t1 - t0, "tiered_s": t2 - t1,
           "children_left": children, "dev_shm_free_bytes": shm_free_bytes()}
    emit("cache", **out)
    if not out["ok"]:
        raise AssertionError(f"cache phase left child processes: {children}")
    return out


# --------------------------------------------------------------- phase 6b

MESH = "mesh/qwen3-1.7b"
MESH_DECODE_STEPS, MESH_TRAIN_STEPS = 8, 2
MESH_MAX_SEQ = 64                 # the decode state's length
MESH_CKPT_DEPTH = 2               # layers in the checkpoint round trip


def tree_bytes(tree) -> int:
    """Bytes of the tensors of nested dicts, lists and tuples (numpy arrays
    too); a Python int counts as an int32, as the lowered steps declare the
    decode state's ``pos``."""
    if isinstance(tree, dict):
        return sum(map(tree_bytes, tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(map(tree_bytes, tree))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, int):
        return 4
    raise TypeError(type(tree).__name__)


def measured(probe, name: str, fn, args):
    """``fn()``; with a ``probe`` dict, between two CUDA events and after a
    reset of the peak memory, recording under ``name`` its event ms, the
    peak bytes allocated, the bytes of its arguments (``args``) and the
    step's own footprint: those arguments plus what the peak adds to the
    bytes allocated before it (the process holds other tensors too, such as
    the prefill's logits during the decode steps)."""
    if probe is None:
        return fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    peak, arg_bytes = torch.cuda.max_memory_allocated(), tree_bytes(args)
    probe[name] = {"ms": start.elapsed_time(end), "peak_bytes": peak,
                   "argument_bytes": arg_bytes,
                   "step_bytes": arg_bytes + peak - before}
    return out


def mesh_shapes():
    """The mesh path's steps as ``ShapeSpec``s: a 4 x 1024 prefill, decode
    steps of 4 over ``MESH_MAX_SEQ`` positions, 4 x 1024 train steps."""
    from repro_torch.models.config import ShapeSpec
    return {"prefill": ShapeSpec("mesh_prefill", 1024, 4, "prefill"),
            "decode": ShapeSpec("mesh_decode", MESH_MAX_SEQ, 4, "decode"),
            "train": ShapeSpec("mesh_train", TRAIN_S, TRAIN_B, "train")}


def lowered_twins(cfg, mesh) -> dict:
    """The mesh path's three steps lowered at their shapes, on the same mesh
    and rules, and traced on ``meta`` tensors (the dry-run's
    ``lower_prefill`` / ``lower_serve_step`` / ``lower_train_step``)."""
    from repro_torch.serve.serve_step import lower_prefill, lower_serve_step
    from repro_torch.sharding import DEFAULT_RULES
    from repro_torch.train.train_step import lower_train_step
    lower = {"prefill": lower_prefill, "decode": lower_serve_step,
             "train": lower_train_step}
    return {k: (shape, lower[k](cfg, shape, mesh, DEFAULT_RULES).compile())
            for k, shape in mesh_shapes().items()}


def roofline_of(cfg, shape, compiled, mesh_name: str = "local") -> dict:
    """A traced step's memory analysis and roofline on the H100's constants
    (``repro_torch.roofline.analysis``), as the dry-run computes a row."""
    from repro_torch.roofline.analysis import analyze, model_flops
    from repro_torch.sharding.rules import mesh_size
    mem = compiled.memory_analysis()
    stats = {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes")}
    stats["bytes_per_device"] = (
        stats["argument_size_in_bytes"] + stats["temp_size_in_bytes"]
        + stats["output_size_in_bytes"] - stats["alias_size_in_bytes"])
    cost = compiled.cost_analysis()
    roof = analyze(cfg.name, shape, mesh_name,
                   mesh_size(compiled.lowered.mesh), cost,
                   compiled.collectives(), cfg, stats)
    return {"memory": stats, "flops": cost["flops"],
            "bytes_accessed": cost["bytes accessed"],
            "model_flops": model_flops(cfg, shape),
            "roofline_ms": roof.step_time_s * 1e3,
            "compute_ms": roof.compute_s * 1e3,
            "memory_ms": roof.memory_s * 1e3, "dominant": roof.dominant,
            "fits_hbm_80g": roof.fits_hbm,
            "trace_s": compiled.trace.seconds}


def twin_report(cfg, twins: dict, probe: dict) -> list:
    """One line a step of the mesh path: its lowered twin's argument bytes
    against the real tensors' (held equal), the twin's bytes per device
    beside the real step's own footprint (``measured``) and the process's
    peak allocation, the roofline ms beside the
    measured event ms (a decode and a train step: the mean over the
    path's steps), the traced FLOPs beside ``model_flops`` (and, for the
    train step, ``train_step_flops``).  Only the argument bytes are
    held; the ratios are written down."""
    steps = {"prefill": 1, "decode": MESH_DECODE_STEPS,
             "train": MESH_TRAIN_STEPS}
    lines = []
    for kind, (shape, compiled) in twins.items():
        r = roofline_of(cfg, shape, compiled)
        real = probe[kind]
        ms = real["ms"] / steps[kind]
        line = {"step": kind, "shape": [shape.global_batch, shape.seq_len],
                "argument_bytes": r["memory"]["argument_size_in_bytes"],
                "real_argument_bytes": real["argument_bytes"],
                "argument_bytes_equal": r["memory"]["argument_size_in_bytes"]
                == real["argument_bytes"],
                "predicted_bytes": r["memory"]["bytes_per_device"],
                "measured_peak_bytes": real["peak_bytes"],
                "measured_step_bytes": real["step_bytes"],
                "memory_ratio": real["step_bytes"]
                / r["memory"]["bytes_per_device"],
                "roofline_ms": r["roofline_ms"], "compute_ms": r["compute_ms"],
                "memory_ms": r["memory_ms"], "dominant": r["dominant"],
                "measured_ms": ms, "time_ratio": ms / r["roofline_ms"],
                "traced_flops": r["flops"], "model_flops": r["model_flops"],
                "trace_s": r["trace_s"]}
        if kind == "train":
            line["train_step_flops"] = train_step_flops(
                cfg, shape.global_batch, shape.seq_len)
        lines.append(line)
    return lines


def leaf_gaps(a: dict, b: dict) -> dict:
    """Each parameter's largest absolute difference between two trees."""
    from repro_torch.models.params import tree_leaves
    right = dict(tree_leaves(b))
    return {"/".join(k): float((v.float() - right[k].float()).abs().max())
            for k, v in tree_leaves(a)}


def mesh_inputs(cfg):
    """The mesh paths' inputs: a 4 x 1024 prefill's token ids (int32, as
    ``batch_structs`` and the lowered twins declare them; seed 0), or
    audio's frame embeddings, and a vlm's image (``model_inputs``); the
    decode steps' token ids (numpy, seed 3; ``mesh_feed``); and the train
    batches (seed 7; audio's frames and a vlm's images from seed 107 on,
    ``with_inputs``), on the card."""
    inputs = {k: v.to(torch.int32) if k == "tokens" else v
              for k, v in model_inputs(cfg, 4, 1024, 0).items()}
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (4, MESH_DECODE_STEPS)).astype(np.int32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batches = []
    for i in range(MESH_TRAIN_STEPS):
        t = torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), generator=gen,
                          device="cuda").to(torch.int32)
        batches.append(with_inputs(cfg, {"tokens": t[:, :-1].contiguous(),
                                         "labels": t[:, 1:].contiguous()},
                                   107 + i))
    return inputs, toks, batches


def mesh_feed(cfg, toks, i: int) -> dict:
    """Decode step ``i``'s input: its column of ``toks``, or audio's frame
    embedding (seed 200 + i, ``step_inputs``)."""
    if cfg.family == "audio":
        return step_inputs(cfg, 4, 200 + i)
    return {"tokens": toks[:, i:i + 1]}


def run_mesh(paths: dict) -> dict:
    """qwen3-1.7b at full width and depth (bf16, seed 0: the weights the
    qwen3 path drew, drawn again) through a one-device mesh
    (``make_local_mesh("cuda")``, ``DEFAULT_RULES``): a prefill of 4 x 1024
    tokens, ``MESH_DECODE_STEPS`` decode steps of a batch of 4 and
    ``MESH_TRAIN_STEPS`` train steps (remat "full", AdamW), all through the
    mesh steps, counted from 0 as a path.  Outside the count the same
    inputs go through the unmeshed steps: the prefill's and every decode
    step's logits must be equal bit for bit, and the first train step's
    loss; after the train steps every parameter must lie within
    ``FLOOR_FACTOR`` times the spread of two unmeshed runs from the same
    params and batches, and never less than one bf16 ulp of its largest
    magnitude (the flash backward's dQ reduce-add sums in a varying
    order).  Launches per prefill, decode step and train step must equal
    the qwen3 paths'.  Last, the trained params cut to ``MESH_CKPT_DEPTH``
    layers are saved and restored with ``shardings_for`` the mesh: the
    same bits, plain tensors on the card.

    The one-rank process group that ``make_local_mesh`` starts is
    destroyed when this path ends (``release_local_mesh``), so that the
    later paths and phases, which fork shard workers, fork a process with
    no live group."""
    import tempfile
    from repro_torch.launch.mesh import make_local_mesh, release_local_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.transformer import build_specs, init_decode_state
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    from repro_torch.sharding import DEFAULT_RULES, shardings_for
    from repro_torch.sharding.rules import NamedSharding, P, mesh_axes
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                             init_state)
    from repro_torch.train.train_step import make_train_step
    arch = MESH.split("/", 1)[1]
    cfg, params = init_model(arch)
    inputs, toks, batches = mesh_inputs(cfg)
    opt_cfg = AdamWConfig(total_steps=MESH_TRAIN_STEPS)

    def serve(prefill, step, marks, probe=None):
        logits = [measured(probe, "prefill",
                           lambda: prefill(params, **inputs),
                           (params, inputs))]
        marks.append(counts())
        state = init_decode_state(cfg, 4, MESH_MAX_SEQ, device="cuda")
        tokens = [toks[:, i:i + 1] for i in range(MESH_DECODE_STEPS)]

        def decode():
            nonlocal state
            for t in tokens:
                out, state = step(params, state, t)
                logits.append(out)
        measured(probe, "decode", decode, (params, state, tokens[0]))
        return logits

    def train(step, probe=None):
        p = tree_to(params, torch.clone)
        opt = init_state(p)
        losses = []

        def steps():
            nonlocal p, opt
            for b in batches:
                p, opt, m = step(p, opt, b)
                losses.append(m["loss"])
        measured(probe, "train", steps, (p, opt, batches[0]))
        torch.cuda.synchronize()
        return p, opt, losses

    mesh = make_local_mesh("cuda")
    try:
        twins = lowered_twins(cfg, mesh)  # traced on meta: no launch
        probe = {}
        t0 = time.perf_counter()
        reset_counts()                   # the mesh path starts here
        marks = []
        got = serve(make_prefill(cfg, mesh, DEFAULT_RULES),
                    make_serve_step(cfg, mesh, DEFAULT_RULES), marks, probe)
        marks.append(counts())
        p_mesh, opt_mesh, loss_mesh = train(make_train_step(
            cfg, opt_cfg, mesh, DEFAULT_RULES, remat="full"), probe)
        launches = counts()              # ... and ends here
        path_s = time.perf_counter() - t0
        want = serve(make_prefill(cfg, "cuda"), make_serve_step(cfg, "cuda"),
                     [])
        plain = make_train_step(cfg, opt_cfg, remat="full")
        p_a, _, loss_a = train(plain)
        p_b, _, loss_b = train(plain)
        # the checkpoint round trip, on the mesh
        ccfg, cut = cut_depth(cfg, p_mesh, MESH_CKPT_DEPTH)
        psh = shardings_for(build_specs(ccfg), mesh, DEFAULT_RULES)
        like = (cut, AdamWState(opt_mesh.step, {}, {}))
        with tempfile.TemporaryDirectory(prefix="repro_torch_mesh") as d:
            ck = CheckpointManager(d)
            t1 = time.perf_counter()
            ck.save(MESH_TRAIN_STEPS, like)
            (back, back_opt), _ = ck.restore(like, shardings=(
                psh, AdamWState(NamedSharding(mesh, P()), {}, {})))
            ckpt_s = time.perf_counter() - t1
        ckpt_equal = all(
            type(b) is torch.Tensor and b.device.type == "cuda"
            and b.dtype == a.dtype and torch.equal(a, b)
            for (_, a), (_, b) in zip(tree_leaves(cut), tree_leaves(back))) \
            and int(back_opt.step) == MESH_TRAIN_STEPS
        axes = mesh_axes(mesh)
        device_type = mesh.device_type
    finally:
        released = release_local_mesh(mesh)
    # launches per prefill / decode step / train step
    n = MESH_DECODE_STEPS
    per_prefill, served = marks
    per_decode = {k: (v - per_prefill[k]) / n for k, v in served.items()}
    per_train = {k: (v - served[k]) / MESH_TRAIN_STEPS
                 for k, v in launches.items()}
    twin_lines = twin_report(cfg, twins, probe)
    gap = leaf_gaps(p_mesh, p_a)
    spread = leaf_gaps(p_a, p_b)
    floor = {k: BF16_ULP * float(v.float().abs().max())
             for k, v in (("/".join(k), v) for k, v in tree_leaves(p_a))}
    bound = {k: max(FLOOR_FACTOR * spread[k], floor[k]) for k in gap}
    worst = max(gap, key=lambda k: gap[k] / bound[k])
    checks = {
        "prefill_logits_bitwise": torch.equal(got[0], want[0]),
        "decode_logits_bitwise": all(torch.equal(a, b)
                                     for a, b in zip(got[1:], want[1:])),
        "first_loss_bitwise": torch.equal(loss_mesh[0], loss_a[0]),
        "params_within_spread": all(gap[k] <= bound[k] for k in gap),
        "prefill_launches": per_prefill == paths[arch]["per_prefill"]
        == expected_per_forward(cfg),
        "decode_launches": per_decode == paths[arch]["per_decode_step"],
        "train_launches": per_train
        == paths[f"train/{arch}"]["per_train_step"]
        == expected_per_train_step(cfg),
        "checkpoint_bitwise": ckpt_equal,
        "one_device_mesh": axes == {"data": 1, "model": 1}
        and device_type == "cuda",
        "group_released": released,
        "losses_finite": all(bool(torch.isfinite(x)) for x in loss_mesh),
        "twin_argument_bytes": all(t["argument_bytes_equal"]
                                   for t in twin_lines),
        "twin_collectives_none": all(
            c.collectives().counts == {} for _, c in twins.values()),
    }
    out = {"arch": cfg.name, "path": MESH, "ok": all(checks.values()),
           "checks": checks, "mesh": axes, "rules": "DEFAULT_RULES",
           "decode_steps": n, "train_steps": MESH_TRAIN_STEPS,
           "losses_mesh": [float(x) for x in loss_mesh],
           "losses_plain": [[float(x) for x in loss_a],
                            [float(x) for x in loss_b]],
           "worst_leaf": worst, "worst_gap": gap[worst],
           "worst_spread": spread[worst], "worst_bound": bound[worst],
           "leaves_bitwise": sum(v == 0 for v in gap.values()),
           "leaves": len(gap),
           "leaves_plain_runs_bitwise": sum(v == 0 for v in spread.values()),
           "path_s": path_s, "checkpoint_s": ckpt_s,
           "per_prefill": {k: v for k, v in per_prefill.items() if v},
           "per_decode_step": {k: v for k, v in per_decode.items() if v},
           "per_train_step": {k: v for k, v in per_train.items() if v}}
    for t in twin_lines:
        emit("mesh_twin", arch=cfg.name, **t)
    emit("mesh", **out)
    del params, p_mesh, opt_mesh, p_a, p_b, got, want, back
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError(f"{MESH} failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return {"launches": launches, "per_prefill": per_prefill,
            "per_decode_step": per_decode, "per_train_step": per_train,
            "step_ms": {"prefill": probe["prefill"]["ms"],
                        "decode": probe["decode"]["ms"] / n,
                        "train": probe["train"]["ms"] / MESH_TRAIN_STEPS}}


MESH2 = "mesh2x2/qwen3-1.7b"
@dataclasses.dataclass(frozen=True)
class Mesh2Run:
    """What a 2 x 2 path runs of its model (full width, seed 0): the bf16
    steps on ``depth`` layers (None: all), ``decode_steps`` decode steps
    and, where it ``trains``, one train step (both tallied and timed,
    ``mesh2_rank``), and the f32 pair on ``f32_depth`` layers
    (``MESH_TRAIN_STEPS`` train steps where the path trains;
    ``f32_decode`` False: its prefill alone)."""
    depth: int | None
    f32_depth: int
    decode_steps: int = MESH_DECODE_STEPS
    trains: bool = True
    f32_decode: bool = True


# The 2 x 2 paths in order, each its model at full width on the four
# ranks, every one drawn at its cut depth.  Depths, to keep the script
# under 1100 s of its 1200: qwen3 whole (its bf16 decode gap sits at its
# bound at 28 layers and misses it at 14), its f32 pair on 4; zamba2 on
# 14 of 38 (the shared block fires at 0, 6 and 12), f32 on 7 (firing at 0
# and 6); mamba2 on 8 of 48 (its four ranks took 173 s at 48 layers, 45 s
# at 8), f32 on 6 (the train phase holds a 6-layer f32 step of the ssm /
# hybrid models at 1e-4, while full-depth f32 rounding alone reaches
# 2.3-3.6e-4; their f32 logits pass 1e-4 sooner: ``mesh2_check``); granite
# on 4 of 32, f32 on 4; musicgen on 8 of 48, f32 on 4; llama-vision on 10
# of 100, the fewest that hold two cross layers (layers 0 and 5: the
# second reads the second layer of the sharded image stack; 10.96 G
# params, 21.9 GB), 2 decode steps, no train step (its AdamW moments of 10
# layers are 88 GB in f32, and a loss and grads across the four gloo
# ranks would stage ~30 GB a rank through the host: its rank-shard flash
# backward is a kernel case, and vlm training across ranks is held
# against the JAX package on the CPU, tests/test_torch_multirank_vlm_audio
# .py), its f32 pair on 5 layers (one cross layer), the prefill alone.
# granite 8 -> 4, llama-vision's f32 decode and zamba2 38 -> 14 were cut
# in that order to fit, and one bf16 train step a path (PERF.md §6).
MESH2_RUNS = {"qwen3-1.7b": Mesh2Run(None, 4),
              "zamba2-1.2b": Mesh2Run(14, 7),
              "mamba2-370m": Mesh2Run(8, 6),
              "granite-moe-3b-a800m": Mesh2Run(4, 4),
              AUDIO: Mesh2Run(8, 4),
              VLM: Mesh2Run(10, 5, decode_steps=2, trains=False,
                            f32_decode=False)}
MESH2_PATHS = tuple(f"mesh2x2/{arch}" for arch in MESH2_RUNS)
MESH2_SHAPE = (2, 2)              # ("data", "model")
# qwen3-1.7b decoding with its KV cache split along the sequence (over
# "model"), under a variant of the rules: 8 steps from an empty state of
# 8 positions, 4 on each "model" rank (``mesh2_variant``).
MESH2_VARIANT = "decode_weights_stationary"
MESH2_VARIANT_ARCH = "qwen3-1.7b"
MESH2_VARIANT_PATH = f"{MESH2}/{MESH2_VARIANT}"
MESH2_VARIANT_MAX_SEQ = 8
MESH2_TIMEOUT_S = 900
# unmeshed kernel runs of the first train step's grad norm: the bf16 flash
# backward sums dQ in an order that varies, which moves qwen3-1.7b's norm
# by up to ~6e-4 between runs on an H100 (as much as the
# kernels-against-plain gap itself)
MESH2_NORM_RUNS = 3


def mesh2_arch(path: str) -> str:
    return path.split("/", 1)[1]


def mesh2_decode_steps(cfg, f32: bool = False) -> int:
    run = MESH2_RUNS[cfg.name]
    return 0 if f32 and not run.f32_decode else run.decode_steps


def mesh2_state(cfg, params, inputs, max_seq: int = MESH_MAX_SEQ) -> dict:
    """An empty decode state of a batch of 4 on the card, its bf16 leaves
    in the params' type (an f32 run keeps its KV cache, and an ssm /
    hybrid its conv state, in f32, since a bf16 cache rounds each new k /
    v, and a last-bit difference that crosses a rounding midpoint moves a
    logit by ~1e-4; the SSD state is f32 in either); a vlm's image K/V
    from the prefill's image and ``params`` (DTensors across ranks, the
    image the global one)."""
    from repro_torch.models.transformer import init_decode_state
    vlm = cfg.family == "vlm"
    state = init_decode_state(cfg, 4, max_seq, device="cuda",
                              img_embeds=inputs["img_embeds"] if vlm else None,
                              params=params if vlm else None)
    dtype = params["final_norm"].dtype
    return {k: v.to(dtype) if torch.is_tensor(v) and v.dtype == torch.bfloat16
            else v for k, v in state.items()}


def mesh2_steps(cfg, params, inputs, toks, batches, prefill, step, train,
                force_ref: bool = False) -> dict:
    """One run of the mesh paths' steps: the prefill's logits, each decode
    step's (``mesh2_decode_steps`` from an empty state of ``MESH_MAX_SEQ``
    positions, ``mesh2_state``; inputs by ``mesh_feed``), and the losses
    and grad norms of ``MESH_TRAIN_STEPS`` train steps from a copy of
    ``params`` (``train`` builds the step; None: the first loss and grad
    norm alone, by ``make_value_and_grad``, ``force_ref`` as asked; False:
    no training)."""
    from repro_torch import is_dtensor
    from repro_torch.train.optimizer import global_norm, init_state
    from repro_torch.train.train_step import make_value_and_grad

    def scalar(t):
        return float(t.full_tensor() if is_dtensor(t) else t)
    out = {"prefill": prefill(params, **inputs), "decode": []}
    state = mesh2_state(cfg, params, inputs)
    f32 = params["final_norm"].dtype == torch.float32
    for i in range(mesh2_decode_steps(cfg, f32)):
        logits, state = step(params, state, **mesh_feed(cfg, toks, i))
        out["decode"].append(logits)
    if train is False:
        return out
    if train is None:
        loss, grads = make_value_and_grad(cfg, remat="full",
                                          force_ref=force_ref)(params,
                                                               batches[0])
        out["losses"] = [scalar(loss)]
        out["grad_norms"] = [scalar(global_norm(grads))]
        return out
    p = tree_to(params, torch.clone)
    opt = init_state(p)
    out["losses"], out["grad_norms"] = [], []
    for b in batches:
        p, opt, m = train(p, opt, b)
        out["losses"].append(scalar(m["loss"]))
        out["grad_norms"].append(scalar(m["grad_norm"]))
    return out


def gap(got, want) -> float:
    """Largest absolute difference of two logits, one sequence at a time
    on the card (``held``'s walk)."""
    err = 0.0
    for g, w in zip(got, want):
        g, w = g.cuda().float(), w.cuda().float()
        err = max(err, float((g - w).abs().max()))
    return err


def floor_of(kern: dict, other: dict, norms: list) -> dict:
    """The gaps of an unmeshed kernel run (``mesh2_steps``) to another run
    of the same steps: logits, and where they trained, first loss and the
    first grad norm of each of ``norms`` (the kernel runs')."""
    out = {"prefill": gap(kern["prefill"], other["prefill"]),
           "decode": max((gap(a, b) for a, b in zip(kern["decode"],
                                                    other["decode"])),
                         default=0.0)}
    if "losses" in kern:
        out["first_loss"] = abs(kern["losses"][0] - other["losses"][0])
        out["first_grad_norm"] = max(abs(n - other["grad_norms"][0])
                                     for n in norms)
    return out


def mesh2_references(cfg, params, inputs, toks, batches, dtype) -> dict:
    """The unmeshed steps on the card, on the host: the kernels' outputs
    and, in bf16, their gap to the plain versions' on the same weights (the
    floor of ``run_mesh2``'s bf16 bounds: logits, the first loss and the
    first step's grad norm, the latter from ``MESH2_NORM_RUNS`` kernel
    runs, each in ``first_grad_norms``, its floor the largest of their
    gaps to the plain run's); in f32 the train steps too, and the same
    kernels-against-plain gaps (printed).

    ssm / hybrid / moe / audio in bf16 also run the same steps on the same
    weights cast to f32 (``exact``), and their floor takes the kernels' gap
    to it (``floor_bf16_vs_f32``): their kernels and plain versions differ
    in f32 sums only (the SSD chunk; decode runs no kernel that rounds
    otherwise, so its kernels-against-plain gap is 0, or, for moe and
    audio, the RMSNorm's last bit), while the mesh rounds each rank's
    partial products to bf16 before their bf16 sum, which Mamba2 layers
    amplify and which moves MoE routes.  ssm / hybrid / audio also keep
    ``exact``'s values (``f32_eval``) and the plain versions' gap to them
    (``floor_plain_vs_f32``): ``mesh2_check`` holds their mesh against
    ``exact`` within ``FLOOR_FACTOR`` times the farthest one-device bf16
    evaluation's distance from it, the largest of the three gaps.  (Held
    against the unmeshed kernels within twice their own distance from
    ``exact``, a draw on which that distance happens to be small fails:
    mamba2's first loss and zamba2's first grad norm on their weights
    drawn at 8 and 14 layers, ``examples/mesh2_floor_witness_torch.py``.)

    A MoE model's runs log their routes (``routing_log``): ``routes`` holds
    the kernel run's, the prefill's in bf16 and the prefill's and decode
    steps' in f32 (``mesh2_routed``), ``routes_floor`` their
    ``route_gap`` to the plain run's (the floor of the mesh's routes,
    ``routes_held``), and in f32 ``route_margins`` each of those calls'
    gap between every token's k-th and (k+1)-th router probability."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.train_step import (make_train_step,
                                              make_value_and_grad)

    def run(force_ref, train, margins=None):
        with routing_log(margins=margins) as log:
            out = mesh2_steps(
                cfg, params, inputs, toks, batches,
                make_prefill(cfg, "cuda", force_ref=force_ref),
                make_serve_step(cfg, "cuda", force_ref=force_ref), train,
                force_ref=force_ref)
        out["routes"] = [t.cpu() for t in log]
        return out
    f32 = dtype == torch.float32
    n = mesh2_routed(cfg, f32)
    margins = [] if f32 else None
    trains = MESH2_RUNS[cfg.name].trains
    kern = run(False, False if not trains else make_train_step(
        cfg, AdamWConfig(total_steps=MESH_TRAIN_STEPS), remat="full")
        if f32 else None, margins)
    ref = {"prefill": kern["prefill"].cpu(),
           "decode": [t.cpu() for t in kern["decode"]],
           "routes": kern["routes"][:n]}
    if trains:
        ref.update(losses=kern["losses"], grad_norms=kern["grad_norms"])
    plain = run(True, None if trains else False)
    if n:
        ref["routes_floor"] = route_gap(kern["routes"][:n],
                                        plain["routes"][:n])
    if f32:                              # printed beside the f32 errors
        ref["floor_kernels_vs_plain"] = floor_of(
            kern, plain, kern.get("grad_norms", [])[:1])
        ref["route_margins"] = margins[:n]
        del plain
    else:
        norms = []
        if trains:
            vg = make_value_and_grad(cfg, remat="full")
            norms = ref["first_grad_norms"] = kern["grad_norms"] + [
                float(global_norm(vg(params, batches[0])[1]))
                for _ in range(MESH2_NORM_RUNS - 1)]
        ref["floor"] = ref["floor_kernels_vs_plain"] = floor_of(
            kern, plain, norms)
        if cfg.family in ("ssm", "hybrid", "moe", "audio"):
            p32 = tree_to(params, lambda t: t.float())
            exact = mesh2_steps(cfg, p32, inputs, toks, batches,
                                make_prefill(cfg, "cuda"),
                                make_serve_step(cfg, "cuda"),
                                None if trains else False)
            del p32
            ref["floor_bf16_vs_f32"] = floor_of(kern, exact, norms)
            ref["floor"] = {k: max(v, ref["floor_bf16_vs_f32"][k])
                            for k, v in ref["floor"].items()}
            if cfg.family != "moe":      # the mesh is held against exact
                ref["floor_plain_vs_f32"] = floor_of(
                    plain, exact, plain.get("grad_norms", []))
                ref["floor"] = {k: max(v, ref["floor_plain_vs_f32"][k])
                                for k, v in ref["floor"].items()}
                ref["f32_eval"] = {
                    "prefill": exact["prefill"].cpu(),
                    "decode": [t.cpu() for t in exact["decode"]],
                    **{k: exact[k] for k in ("losses", "grad_norms")
                       if k in exact}}
            del exact
        del plain
    del kern
    torch.cuda.empty_cache()
    return ref


def mesh2_routed(cfg, f32: bool) -> int:
    """The route calls a 2 x 2 path holds against the unmeshed run's (the
    first ones of a run of ``mesh2_steps``): the prefill's in bf16, and the
    prefill's and the decode steps' in f32; 0 without MoE layers."""
    if cfg.family != "moe":
        return 0
    return cfg.n_layers * (1 + MESH_DECODE_STEPS * f32)


def mesh2_weights(arch: str, dtype, depth=None, place=None, seed: int = 0):
    """(cfg, params) of a 2 x 2 path on the card: the model on its first
    ``depth`` layers (default: all) drawn at that depth from ``seed`` as
    ``init_model`` draws it, a vlm's gates opened (``open_gates``), each
    leaf cast to ``dtype`` and, with ``place(path, leaf)``, replaced by
    what that returns (a rank's shard) as it is drawn, so that the whole
    model is never on the card at once."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)

    def leaf(path, t):
        if path == ("cross", "ca_gate"):
            t = open_gates(cfg, {"cross": {"ca_gate": t}},
                           seed)["cross"]["ca_gate"]
        t = t.to(dtype)
        return t if place is None else place(path, t)
    return cfg, init_params(cfg,
                            torch.Generator(device="cuda").manual_seed(seed),
                            each=leaf)


def mesh2_rank(rank: int, job: dict) -> dict:
    """One rank of ``run_mesh2``, for each model of ``job["archs"]`` in
    turn: the model (seed 0, bf16, full width, its ``MESH2_RUNS`` depth)
    placed on the (2, 2) mesh by ``DEFAULT_RULES`` leaf by leaf as it is
    drawn (``mesh2_placed``), then the mesh paths' steps through
    ``make_prefill`` / ``make_serve_step`` / ``make_train_step`` on it
    (its ``MESH2_RUNS`` decode and train steps), counted from 0 (this
    process's counts); the first prefill, decode step and train step
    under ``CollectiveTally``, the second prefill, the last decode step
    and the one train step (cold, under the tally) timed (every rank
    starts each at a barrier, and samples the card's memory in use by
    every process after it), each beside the dry-run twin's count of its
    collectives taken on this mesh before the steps (``mesh2_twins``); the
    peak memory of the draw and of the steps apart; then the f32 pair.
    After qwen3-1.7b, its decode under ``MESH2_VARIANT``
    (``mesh2_variant``). Returns, by model, this rank's blocks of every
    logits tensor, the losses and grad norms, its launches, times, peak
    memory and collectives."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    from repro_torch.sharding import DEFAULT_RULES
    from repro_torch.sharding.collectives import (STAGED, CollectiveTally,
                                                  stage_through_host)
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stage_through_host()
    mesh = make_mesh(MESH2_SHAPE, ("data", "model"), "cuda")
    common = {"coord": tuple(mesh.get_coordinate()),
              "backend": dist.get_backend(),
              "device": torch.cuda.get_device_name(0)}
    card_used = []

    def placed(arch, dtype, depth=None, rules=DEFAULT_RULES):
        return mesh2_placed(mesh, arch, dtype, depth, rules)

    def timed(fn):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        free, total = torch.cuda.mem_get_info()
        card_used.append(total - free)
        return r, (time.perf_counter() - t0) * 1e3

    results = {}
    for arch in job["archs"]:
        t_arch = time.perf_counter()
        card_used.clear()
        STAGED.clear()
        run = MESH2_RUNS[arch]
        torch.cuda.reset_peak_memory_stats()
        cfg, params = placed(arch, torch.bfloat16, run.depth)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t_arch
        draw_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()     # the steps' peak from here
        trains = run.trains
        n_dec = mesh2_decode_steps(cfg)
        inputs, toks, batches = mesh_inputs(cfg)
        prefill = make_prefill(cfg, mesh, DEFAULT_RULES)
        step = make_serve_step(cfg, mesh, DEFAULT_RULES)
        train = make_train_step(cfg, AdamWConfig(
            total_steps=MESH_TRAIN_STEPS), mesh, DEFAULT_RULES, remat="full")
        t_twin = time.perf_counter()
        twins = mesh2_twins(cfg, mesh, DEFAULT_RULES,
                            ("prefill", "decode") + ("train",) * trains)
        twin_s = time.perf_counter() - t_twin
        comm, ms = {}, {}
        reset_counts()                   # this rank's path starts here
        # a MoE model's routes: the first prefill's, every decode step's
        # and the first train step's (its forward and its recompute)
        with CollectiveTally() as tally, routing_log() as routes:
            first = prefill(params, **inputs)
        comm["prefill"] = tally
        logits, ms["prefill"] = timed(lambda: prefill(params, **inputs))
        marks = [counts()]
        state = mesh2_state(cfg, params, inputs)
        decode = []
        with routing_log() as more:
            for i in range(n_dec):
                feed = mesh_feed(cfg, toks, i)
                if i == 0:
                    with CollectiveTally() as tally:
                        lg, state = step(params, state, **feed)
                    comm["decode"] = tally
                elif i == n_dec - 1:
                    (lg, state), ms["decode"] = timed(
                        lambda: step(params, state, **feed))
                else:
                    lg, state = step(params, state, **feed)
                decode.append(mesh2_local(lg))
        routes += more
        marks.append(counts())
        losses, norms = [], []
        if trains:                       # one step: the checks read its
            p = tree_to(params, torch.clone)      # loss and grad norm
            opt = init_state(p)

            def tallied():
                with CollectiveTally() as tally, routing_log() as more:
                    return train(p, opt, batches[0]), tally, more
            ((p, opt, m), comm["train"], more), ms["train"] = timed(tallied)
            routes += more
            losses.append(float(m["loss"].full_tensor()))
            norms.append(float(m["grad_norm"].full_tensor()))
            del p, opt, m
        launches = counts()              # ... and ends here
        out = dict(common)
        out.update(
            prefill=mesh2_local(logits),
            prefill_first_equal=bool(torch.equal(first.to_local(),
                                                 logits.to_local())),
            placements={"prefill": list(map(repr, logits.placements)),
                        "decode": list(map(repr, lg.placements))},
            decode=decode, losses=losses, grad_norms=norms, ms=ms,
            launches=launches, marks=marks,
            routes=[t.cpu() for t in routes],
            comm={k: mesh2_comm(t) for k, t in comm.items()},
            twin=twins, twin_s=twin_s,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            draw_peak_gb=draw_peak_gb,
            card_used_gb=max(card_used) / 1e9, draw_s=draw_s)
        if cfg.family == "vlm":          # the image K/V's placements
            out["img_kv_placements"] = list(map(repr,
                                                state["img_kv"][0].placements))
        del params, first, logits, state
        torch.cuda.empty_cache()
        # the f32 pair, on its own depth
        t_f32 = time.perf_counter()
        cfg32, p32 = placed(arch, torch.float32, run.f32_depth)
        with routing_log() as routes:
            r32 = mesh2_steps(cfg32, p32, inputs, toks, batches,
                              make_prefill(cfg32, mesh, DEFAULT_RULES),
                              make_serve_step(cfg32, mesh, DEFAULT_RULES),
                              make_train_step(cfg32, AdamWConfig(
                                  total_steps=MESH_TRAIN_STEPS), mesh,
                                  DEFAULT_RULES, remat="full")
                              if trains else False)
        out["f32"] = {"prefill": mesh2_local(r32["prefill"]),
                      "decode": [mesh2_local(t) for t in r32["decode"]],
                      "losses": r32.get("losses", []),
                      "grad_norms": r32.get("grad_norms", []),
                      "routes": [t.cpu() for t in
                                 routes[:mesh2_routed(cfg32, True)]]}
        out["staged"] = {k: dict(v) for k, v in STAGED.items()}
        out["seconds"] = time.perf_counter() - t_arch
        out["seconds_f32"] = time.perf_counter() - t_f32
        del p32, r32, inputs, batches
        torch.cuda.empty_cache()
        results[arch] = out
        if arch == MESH2_VARIANT_ARCH and job.get("variant"):
            results[MESH2_VARIANT_PATH] = dict(
                mesh2_variant(mesh, placed, timed, card_used),
                coord=common["coord"])
    return results


def mesh2_placed(mesh, arch: str, dtype, depth=None, rules=None,
                 seed: int = 0):
    """(cfg, params) of ``mesh2_weights`` placed on ``mesh`` by ``rules``,
    each leaf as it is drawn: this rank keeps its shard (``distribute_tree``
    copies it) and the drawn leaf is freed before the next one."""
    from repro_torch.models.transformer import build_specs
    from repro_torch.sharding import distribute_tree, shardings_for
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    shardings = shardings_for(build_specs(cfg), mesh, rules)

    def place(path, t):
        sh = shardings
        for k in path:
            sh = sh[k]
        return distribute_tree(t, sh)
    cfg, params = mesh2_weights(arch, dtype, depth, place, seed)
    torch.cuda.empty_cache()
    return cfg, params


def mesh2_local(t):
    """(global offset, this rank's block on the host) of a DTensor; a
    partial sum (the decode step's head leaves its logits partial over
    "data") is reduced first."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    t = t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])
    _, offset = compute_local_shape_and_global_offset(
        t.shape, t.device_mesh, t.placements)
    return tuple(offset), t.to_local().cpu()


def mesh2_comm(tally) -> dict:
    """A ``CollectiveTally``'s calls and bytes by the reference's kind
    (``by_kind``: an all-reduce's bytes twice its result's), and its calls
    by collective."""
    counts, nbytes = tally.by_kind()
    return {"counts": counts, "bytes": nbytes, "calls": dict(tally.calls)}


def twin_of(cfg, shape, mesh, rules) -> dict:
    """A step's dry-run twin on this rank's own mesh, compiled as the
    dry-run compiles a cell: the step run on ``meta`` DTensors as this
    rank runs it (``Lowered.count``; nothing launched, nothing sent),
    at the dry-run's two depths and extrapolated to the path's depth
    (``launch.dryrun.compile_step``; at the path's depth where that is no
    deeper than 3p or not a multiple of p, such as zamba2's 14 layers
    over a period of 6).  Its collectives by kind, as
    ``mesh2_comm`` gives a real step's, and what it predicts for this
    rank: FLOPs, bytes accessed, temp and bytes per device (argument +
    temp + output - alias), and the roofline's ms of its compute and
    memory terms (H100 SXM constants); and the shapes of its allocations
    as wide as the vocab (``vocab_wide``: the loss's blocks)."""
    from repro_torch.launch.dryrun import compile_step, lower_step, period
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS
    c = (compile_step(cfg, shape, mesh, rules, "full")
         if cfg.n_layers % period(cfg) == 0
         else lower_step(cfg, shape, mesh, rules).compile())
    coll, cost, mem = c.collectives(), c.cost_analysis(), c.memory_analysis()
    flops, nbytes = cost["flops"], cost["bytes accessed"]
    return {"counts": coll.counts, "bytes": coll.bytes_by_kind,
            "vocab_wide": sorted(t for t in c.trace.shapes
                                 if len(t) > 1 and t[-1] == cfg.vocab),
            "predicted": {
                "flops": flops, "bytes_accessed": nbytes,
                "temp_bytes": mem.temp_size_in_bytes,
                "bytes_per_device": (mem.argument_size_in_bytes
                                     + mem.temp_size_in_bytes
                                     + mem.output_size_in_bytes
                                     - mem.alias_size_in_bytes),
                "roofline_ms": max(flops / PEAK_FLOPS,
                                   nbytes / HBM_BW) * 1e3}}


def mesh2_twins(cfg, mesh, rules, kinds) -> dict:
    """The dry-run twin (``twin_of``) of each of the path's steps of
    ``kinds`` (``mesh_shapes``), lowered on this rank's own ``mesh`` under
    ``rules``."""
    return {kind: twin_of(cfg, shape, mesh, rules)
            for kind, shape in mesh_shapes().items() if kind in kinds}


def mesh2_variant(mesh, placed, timed, card_used) -> dict:
    """qwen3-1.7b decoding under ``MESH2_VARIANT`` (its rules: no FSDP,
    the KV heads whole, the caches' sequence over "model"), the model
    drawn and placed again by those rules: ``MESH_DECODE_STEPS`` steps
    from an empty state of ``MESH2_VARIANT_MAX_SEQ`` positions in bf16 at
    full depth (counted from 0, the first step under ``CollectiveTally``,
    the last timed), then in f32 on its ``MESH2_RUNS`` f32 depth.  Returns
    this rank's logits blocks, its cache block along the sequence and the
    positions written into it (nonzero), launches, times and collectives,
    beside the dry-run twin's count of that step on this rank's mesh,
    taken before the steps run."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models.config import ShapeSpec
    from repro_torch.serve.serve_step import make_serve_step
    from repro_torch.sharding import DEFAULT_RULES
    from repro_torch.sharding.collectives import STAGED, CollectiveTally
    arch = MESH2_VARIANT_ARCH
    rules = apply_variant(DEFAULT_RULES, arch, "decode", MESH2_VARIANT)
    out = {}
    t0 = time.perf_counter()
    STAGED.clear()
    card_used.clear()
    for dtype, depth in ((torch.bfloat16, None),
                         (torch.float32, MESH2_RUNS[arch].f32_depth)):
        cfg, params = placed(arch, dtype, depth, rules)
        step = make_serve_step(cfg, mesh, rules)
        _, toks, _ = mesh_inputs(cfg)
        state = mesh2_state(cfg, params, {}, MESH2_VARIANT_MAX_SEQ)
        r = out[str(dtype).rsplit(".", 1)[1]] = {"decode": []}
        f32 = dtype == torch.float32
        if not f32:                      # the tallied step's twin
            r["twin"] = twin_of(cfg, ShapeSpec(
                "mesh2_variant_decode", MESH2_VARIANT_MAX_SEQ, 4, "decode"),
                mesh, rules)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()                   # the variant's path starts here
        for i in range(MESH_DECODE_STEPS):
            feed = mesh_feed(cfg, toks, i)
            if i == 0 and not f32:
                with CollectiveTally() as tally:
                    lg, state = step(params, state, **feed)
                r["comm"] = mesh2_comm(tally)
            elif i == MESH_DECODE_STEPS - 1 and not f32:
                (lg, state), r["ms"] = timed(lambda: step(params, state,
                                                          **feed))
            else:
                lg, state = step(params, state, **feed)
            r["decode"].append(mesh2_local(lg))
        r["launches"] = counts()         # ... and ends here
        k = state["k"]
        size, offset = compute_local_shape_and_global_offset(
            k.shape, k.device_mesh, k.placements)
        local = k.to_local()
        r["seq_block"] = [offset[2], size[2]]
        r["written"] = [offset[2] + p for p in range(size[2])
                        if bool(local[:, :, p].any())]
        r["cache_placements"] = list(map(repr, k.placements))
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, state, lg
        torch.cuda.empty_cache()
    out["staged"] = {k: dict(v) for k, v in STAGED.items()}
    out["card_used_gb"] = max(card_used) / 1e9 if card_used else None
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh2_assemble(blocks: list, shape) -> torch.Tensor:
    """A full tensor of ``shape`` from the ranks' (global offset, block)
    pairs; a block that several ranks hold (a replicated dimension) must
    be the same bits on each, and every element must be covered."""
    full = torch.empty(shape, dtype=blocks[0][1].dtype)
    seen = torch.zeros(shape, dtype=torch.bool)
    for offset, blk in blocks:
        where = tuple(slice(o, o + n) for o, n in zip(offset, blk.shape))
        if seen[where].any() and not torch.equal(full[where], blk):
            raise AssertionError(f"ranks disagree on the block at {offset}")
        full[where], seen[where] = blk, True
    if not bool(seen.all()):
        raise AssertionError("the ranks' blocks do not cover the tensor")
    return full


def mesh2_replay(arch: str, dtype, routes: list) -> dict:
    """The unmeshed kernel steps of a 2 x 2 path (``mesh2_steps``; bf16 at
    the path's depth: the prefill, the decode steps and the first loss and
    grad norm; f32 on the f32 cut: the prefill and the decode steps), each
    MoE layer on the experts that ``routes`` (the ranks' log of the same
    calls) gave it (``routing_log(replay=...)``); logits on the host."""
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    f32 = dtype == torch.float32
    run = MESH2_RUNS[arch]
    cfg, params = mesh2_weights(arch, dtype, run.f32_depth if f32
                                else run.depth)
    inputs, toks, batches = mesh_inputs(cfg)
    with routing_log(replay=[t.cuda() for t in routes]):
        out = mesh2_steps(cfg, params, inputs, toks, batches,
                          make_prefill(cfg, "cuda"),
                          make_serve_step(cfg, "cuda"), False if f32 else None)
    out["prefill"] = out["prefill"].cpu()
    out["decode"] = [t.cpu() for t in out["decode"]]
    del params, inputs, batches
    torch.cuda.empty_cache()
    return out


def expected_per_decode_step(cfg) -> dict:
    """Kernel launches of one decode step: a forward's RMSNorms, no SSD
    chunk launch and no flash launch for self-attention (decode attention
    and the SSD step are plain torch); a vlm's cross-attention launches
    flash (one query row) each time a cross layer fires."""
    fwd = expected_per_forward(cfg)
    return {**fwd, "ssd_chunk": 0, "flash_attention": cross_fired(cfg),
            "flash_attention/wgmma": cross_fired(cfg)}


def mesh2_prepare(arch: str) -> dict:
    """The parent's share of a 2 x 2 path, before the ranks start: the
    unmeshed references (``mesh2_references``) in bf16 at the path's depth
    and in f32 on its f32 depth (``MESH2_RUNS``).  Frees every tensor it
    put on the card.  (Each rank counts the dry-run twin's collectives on
    its own mesh: ``mesh2_twins``.)"""
    t0 = time.perf_counter()
    depth = MESH2_RUNS[arch].depth
    cfg, params = mesh2_weights(arch, torch.bfloat16, depth)
    inputs, toks, batches = mesh_inputs(cfg)
    ref = mesh2_references(cfg, params, inputs, toks, batches, torch.bfloat16)
    variant = mesh2_variant_references(cfg, params) \
        if arch == MESH2_VARIANT_ARCH else None
    del params
    torch.cuda.empty_cache()
    cfg32, p32 = mesh2_weights(arch, torch.float32,
                               MESH2_RUNS[arch].f32_depth)
    ref32 = mesh2_references(cfg32, p32, inputs, toks, batches, torch.float32)
    del p32, inputs, batches
    torch.cuda.empty_cache()
    return {"cfg": cfg, "depth": depth, "ref": ref, "ref32": ref32,
            "variant": variant, "seconds": time.perf_counter() - t0}


def mesh2_variant_references(cfg, params) -> dict:
    """The parent's share of ``mesh2_variant``: the unmeshed decode of
    ``MESH_DECODE_STEPS`` steps from an empty state of
    ``MESH2_VARIANT_MAX_SEQ`` positions, on the host: in bf16 the kernels'
    logits, and the floor of the variant's bound, the larger of their gap
    to the plain versions' and to the same steps on the weights cast to f32
    (decode runs the RMSNorm kernel alone, which differs from its plain
    version in a last bit, while the mesh's other split rounds each
    layer's partial products in bf16 once more: the ssm / hybrid / moe
    rule of ``mesh2_references``); in f32 on its f32 depth the
    kernels' logits."""
    from repro_torch.serve.serve_step import make_serve_step
    _, toks, _ = mesh_inputs(cfg)

    def run(c, p, force_ref=False):
        step = make_serve_step(c, "cuda", force_ref=force_ref)
        state = mesh2_state(c, p, {}, MESH2_VARIANT_MAX_SEQ)
        out = []
        for i in range(MESH_DECODE_STEPS):
            lg, state = step(p, state, **mesh_feed(c, toks, i))
            out.append(lg.cpu())
        return out
    kern, plain = run(cfg, params), run(cfg, params, True)
    p32 = tree_to(params, lambda t: t.float())
    exact = run(cfg, p32)
    del p32
    floor = {"kernels_vs_plain": max(gap(a, b) for a, b in zip(kern, plain)),
             "bf16_vs_f32": max(gap(a, b) for a, b in zip(kern, exact))}
    cfg32, p32 = mesh2_weights(cfg.name, torch.float32,
                               MESH2_RUNS[cfg.name].f32_depth)
    want32 = run(cfg32, p32)
    del p32, plain, exact
    torch.cuda.empty_cache()
    return {"decode": kern, "floor": floor, "f32_decode": want32}


def card_memory_watch(stop: threading.Event, out: list,
                      every_s: float = 0.2) -> None:
    """Until ``stop`` is set, the card's memory in use by every process
    (``mem_get_info``: total less free), sampled into ``out``."""
    while not stop.is_set():
        free, total = torch.cuda.mem_get_info()
        out.append(total - free)
        stop.wait(every_s)


def run_mesh2(paths: dict) -> dict:
    """The ``MESH2_PATHS``: ``mesh2x2/qwen3-1.7b``, ``mesh2x2/zamba2-1.2b``
    (the shared block firing at 0, 6 and 12), ``mesh2x2/mamba2-370m``,
    ``mesh2x2/granite-moe-3b-a800m`` (40 experts top-8, 20 a rank),
    ``mesh2x2/musicgen-large`` (frame embeddings) and
    ``mesh2x2/llama-3.2-vision-90b`` (two cross layers, gates open, the
    decode state's image K/V from the image), each its model at full width
    (bf16, seed 0, drawn at its ``MESH2_RUNS`` depth) prefilling 4 x
    1024 tokens, taking its decode steps of a batch of 4 and one train
    step (remat "full", AdamW; none for llama-vision; the f32 pairs
    ``MESH_TRAIN_STEPS``) through
    ``make_prefill`` / ``make_serve_step`` / ``make_train_step`` on a real
    (2, 2) ("data", "model") ``DeviceMesh`` of four ranks under
    ``DEFAULT_RULES`` (``mesh2_rank``, which runs the paths in turn), and
    qwen3-1.7b decoding under ``MESH2_VARIANT`` (``mesh2_variant``, held
    by ``mesh2_variant_check``).  The
    four ranks share the one card: spawned processes
    (``launch.ranks.run_ranks``), gloo with CUDA tensors (NCCL refuses two
    ranks on one device), the functional all-gather staged through the
    host (``sharding.collectives``); they load the library phase 2 built.
    The parent computes every reference first and frees its copies on the
    card before the ranks start.

    Held, for each path, on the same inputs as ``mesh/qwen3-1.7b``:

    * bf16: the prefill's and every decode step's logits, the first loss
      and the first train step's grad norm, against the unmeshed steps on
      the same weights, within ``FLOOR_FACTOR`` times the unmeshed
      kernels-against-plain gap of the same run (``mesh2_references``;
      the largest of each element's gaps, and of the grad norm's gaps to
      each of the unmeshed kernel runs; moe: the larger of that gap and
      the unmeshed bf16 steps' gap to their f32 evaluation, on the
      unmeshed steps replayed on the ranks' experts; ssm / hybrid / audio:
      against that f32 evaluation, within ``FLOOR_FACTOR`` times the
      largest of the kernels' and the plain versions' gaps to it and to
      each other; a
      logit also gets one bf16 ulp of its value, ``close_enough``'s rule
      for bf16, and the loss and the grad norm, both f32, one f32 ulp of
      theirs); a MoE model's prefill routes by the routing rule
      (``routes_held``: at most ``ROUTE_FACTOR`` times the routes that
      the unmeshed kernels flip against the plain versions), and the
      same on every rank (the route is the whole batch's);
    * f32, the model on its f32 depth (``MESH2_RUNS``; and the decode
      state in f32, ``mesh2_steps``): the same steps' logits, losses and
      grad norms at ``SMALL_F32_TOL`` (1e-4); ssm / hybrid logits within
      the larger of 1e-4 and ``FLOOR_FACTOR`` times the same cut's f32
      kernels-against-plain gap (absolute; 1e-4 relative), as the train
      phase holds their f32 steps; a MoE model's prefill and decode routes
      by the routing rule against the f32 floor, and where one differs its
      logits against the unmeshed steps replayed on the ranks' experts
      (``mesh2_replay``);
    * each rank's launches per prefill, decode step and train step equal
      the expected counts and the one-card paths' (every flash launch the
      ``wgmma`` one; a path cut in depth against its cut
      model's expected counts alone); a vlm's image K/V placed as
      ``CACHE_AXES["img_kv"]`` gives them;
    * the ranks did not rebuild the kernels (``build.log`` untouched).

    * on each rank, the first prefill's, decode step's and train step's
      collectives (``CollectiveTally``: calls and bytes by the reference's
      kind) equal the dry-run twin's count of the same step, lowered on
      the rank's own mesh and run on ``meta`` DTensors before the steps
      (``mesh2_twins``, ``twin_held``).

    Printed, not held: each rank's step times, peak memory, the card's
    memory in use while the ranks ran (sampled by the parent, and by each
    rank after its timed steps), the collectives beside the twin's
    (``mesh2_collectives`` lines) and the host-staged all-gathers."""
    from repro_torch.kernels import _build
    from repro_torch.launch.ranks import run_ranks
    torch.backends.cuda.matmul.allow_tf32 = False    # as the ranks have it
    torch.backends.cudnn.allow_tf32 = False          # (the conv's f32 too)
    archs = [mesh2_arch(p) for p in MESH2_PATHS]
    prep = {arch: mesh2_prepare(arch) for arch in archs}
    variant = prep.get(MESH2_VARIANT_ARCH, {}).get("variant")
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_allocated() / 1e9
    log = _build.BUILD_DIR / "build.log"
    stamp = log.stat().st_mtime_ns
    used, stop = [], threading.Event()
    watch = threading.Thread(target=card_memory_watch, args=(stop, used),
                             daemon=True)
    watch.start()
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(mesh2_rank, 4, {"archs": archs,
                                          "variant": variant is not None},
                          timeout=MESH2_TIMEOUT_S)
    finally:
        stop.set()
        watch.join()
    ranks_s = time.perf_counter() - t0
    card = {"parent_allocated_gb": parent_gb,
            "card_used_peak_gb": max(used) / 1e9, "samples": len(used),
            "ranks_s": ranks_s,
            "library_not_rebuilt": log.stat().st_mtime_ns == stamp}
    out, failed = {}, {}
    for path in MESH2_PATHS:
        arch = mesh2_arch(path)
        out[path], bad = mesh2_check(path, prep.pop(arch),
                                     [r[arch] for r in ranks], paths, card)
        if bad:
            failed[path] = bad
    if variant is not None:
        out[MESH2_VARIANT_PATH], bad = mesh2_variant_check(
            variant, [r[MESH2_VARIANT_PATH] for r in ranks], card)
        if bad:
            failed[MESH2_VARIANT_PATH] = bad
    if failed:
        raise AssertionError(f"2 x 2 paths failed: {failed}")
    return out


def mesh2_check(path: str, prep: dict, ranks: list, paths: dict,
                card: dict) -> tuple:
    """One 2 x 2 path's checks (``run_mesh2``) from the ranks' results and
    the parent's references; emits its ``mesh2_collectives`` and ``mesh2``
    lines.  Returns (the path's launches, the names of its failed
    checks)."""
    arch, cfg, ref, ref32 = (mesh2_arch(path), prep["cfg"], prep["ref"],
                             prep["ref32"])
    coords = [r["coord"] for r in ranks]
    B, S, V = 4, 1024, cfg.vocab
    run = MESH2_RUNS[arch]
    n_dec, trains = mesh2_decode_steps(cfg), run.trains
    pre = mesh2_assemble([r["prefill"] for r in ranks], (B, S, V))
    dec = [mesh2_assemble([r["decode"][i] for r in ranks], (B, 1, V))
           for i in range(n_dec)]
    floor = ref["floor"]
    bounds = {k: FLOOR_FACTOR * v for k, v in floor.items()}
    if trains:
        for k, want in (("first_loss", ref["losses"][0]),
                        ("first_grad_norm", max(ref["first_grad_norms"]))):
            bounds[k] += float(np.spacing(np.float32(abs(want))))

    def bf16_gaps(want, norms):
        """(prefill and decode within their bounds, the four gaps) of the
        ranks' bf16 steps against the unmeshed ``want``."""
        pre_ok, pre_gap = held_tol(pre, want["prefill"], bounds["prefill"],
                                   torch.bfloat16)
        dec_ok, dec_gap = True, 0.0
        for a, b in zip(dec, want["decode"]):
            ok, err = held_tol(a, b, bounds["decode"], torch.bfloat16)
            dec_ok, dec_gap = dec_ok and ok, max(dec_gap, err)
        gaps = {"prefill": pre_gap, "decode": dec_gap}
        if trains:
            gaps["first_loss"] = abs(ranks[0]["losses"][0]
                                     - want["losses"][0])
            gaps["first_grad_norm"] = max(abs(ranks[0]["grad_norms"][0] - n)
                                          for n in norms)
        return (pre_ok, dec_ok), gaps
    # A MoE path's bf16 values are held against the unmeshed kernel steps
    # replayed on the ranks' experts (``mesh2_replay``; ``pair_check``'s
    # "replay"), its routes by the routing rule below: a flipped expert
    # moves its token by far more than any rounding, and the mesh flips as
    # many as the plain versions do.  The gaps on the unmeshed steps' own
    # routes are printed.
    # ssm / hybrid / audio: against the f32 evaluation of the same weights
    # (``mesh2_references``).  Either way the gaps to the unmeshed kernel
    # steps are printed.
    kernel_gaps = None
    if cfg.family == "moe":
        rep = mesh2_replay(arch, torch.bfloat16, ranks[0]["routes"])
        (pre_ok, dec_ok), gaps = bf16_gaps(rep, rep["grad_norms"])
        del rep
    elif "f32_eval" in ref:
        (pre_ok, dec_ok), gaps = bf16_gaps(ref["f32_eval"],
                                           ref["f32_eval"].get("grad_norms"))
    else:
        (pre_ok, dec_ok), gaps = bf16_gaps(ref, ref.get("first_grad_norms"))
    if cfg.family == "moe" or "f32_eval" in ref:
        kernel_gaps = bf16_gaps(ref, ref.get("first_grad_norms"))[1]
    del pre, dec
    routing, route_checks, want32 = None, {}, ref32
    if cfg.family == "moe":
        # The MoE routing rule (``routes_held``) against the unmeshed
        # kernels' routes, its floor their ``route_gap`` to the plain
        # versions' (bf16: the prefill's, in pairs; f32: the prefill's and
        # the decode steps', in first flips), the route the same on every
        # rank.  Where an f32 route
        # differs (a near-tie of the k-th and (k+1)-th expert that the
        # mesh's other summation order flips: the unmeshed run's margins
        # of the flipped pairs are printed), the f32 logits are held at
        # 1e-4 against the unmeshed steps replayed on the ranks' experts,
        # not against another computation.
        got = route_gap(ranks[0]["routes"][:cfg.n_layers], ref["routes"])
        got_r32 = ranks[0]["f32"]["routes"]
        got32 = route_gap(got_r32, ref32["routes"])
        held32 = routes_held(got32, ref32["routes_floor"], B * S, True)
        flips = [m[(a != b).any(-1)] for a, b, m in
                 zip(got_r32, ref32["routes"], ref32["route_margins"])]
        flips = torch.cat(flips) if flips else torch.zeros(0)
        routing = {"routing_agreement": got["agreement"], **routes_held(
            got, ref["routes_floor"], B * S, False),
                   "f32_routing_agreement": got32["agreement"],
                   **{f"f32_{k}": v for k, v in held32.items()},
                   "f32_rule": ("tolerance" if got32["agreement"] == 1
                                else "replay"),
                   "f32_flipped_pairs": int(flips.numel()),
                   "f32_flipped_margins_max":
                   float(flips.max()) if flips.numel() else None}
        route_checks = {
            "routes_within_rule": routing["routes_ok"],
            "routes_same_on_every_rank": all(
                len(r["routes"]) == len(ranks[0]["routes"])
                and all(torch.equal(a, b)
                        for a, b in zip(r["routes"], ranks[0]["routes"]))
                for r in ranks),
            "f32_routes_within_rule": held32["routes_ok"]}
        if got32["agreement"] < 1:
            want32 = mesh2_replay(arch, torch.float32, got_r32)
    # f32 logits at 1e-4; ssm / hybrid at the larger of 1e-4 and
    # FLOOR_FACTOR times the cut's own f32 kernels-against-plain gap
    # (Mamba2 layers amplify f32 rounding past 1e-4 within 6 layers)
    tol32 = {k: SMALL_F32_TOL if cfg.family not in ("ssm", "hybrid") else
             max(SMALL_F32_TOL,
                 FLOOR_FACTOR * ref32["floor_kernels_vs_plain"][k])
             for k in ("prefill", "decode")}
    pre32 = mesh2_assemble([r["f32"]["prefill"] for r in ranks], (B, S, V))
    f32_pre_ok, f32_pre_err = held_tol(pre32, want32["prefill"],
                                       tol32["prefill"], rtol=SMALL_F32_TOL)
    if want32 is not ref32:
        routing["f32_prefill_max_abs_err_own_routing"] = held_tol(
            pre32, ref32["prefill"], tol32["prefill"],
            rtol=SMALL_F32_TOL)[1]
    f32_dec_ok, f32_dec_err = True, 0.0
    for i in range(mesh2_decode_steps(cfg, True)):
        d = mesh2_assemble([r["f32"]["decode"][i] for r in ranks],
                           (B, 1, V))
        ok, err = held_tol(d, want32["decode"][i], tol32["decode"],
                           rtol=SMALL_F32_TOL)
        f32_dec_ok, f32_dec_err = f32_dec_ok and ok, max(f32_dec_err, err)
    del pre32, want32
    got32 = np.asarray(ranks[0]["f32"]["losses"]
                       + ranks[0]["f32"]["grad_norms"])
    want32 = np.asarray(ref32.get("losses", []) + ref32.get("grad_norms", []))
    f32_scalars_ok = bool(np.allclose(got32, want32, atol=SMALL_F32_TOL,
                                      rtol=SMALL_F32_TOL))
    per = []
    for r in ranks:
        pre_m, dec_m = r["marks"]
        per.append({
            "prefill": {k: v / 2 for k, v in pre_m.items()},
            "decode": {k: (v - pre_m[k]) / n_dec for k, v in dec_m.items()},
            "train": {k: v - dec_m[k]
                      for k, v in r["launches"].items()}})
    # the one-card paths' counts, where the path runs their model whole
    whole = prep["depth"] is None
    one_pre = paths[arch]["per_prefill"] if whole else None
    one_dec = paths[arch]["per_decode_step"] if whole else None
    one_train = paths[f"train/{arch}"]["per_train_step"] if whole else None
    want = {"prefill": expected_per_forward(cfg),
            "decode": expected_per_decode_step(cfg),
            "train": expected_per_train_step(cfg) if trains
            else dict.fromkeys(expected_per_train_step(cfg), 0)}
    one = paths.get(MESH, {}).get("step_ms", {}) \
        if path == MESH2 and whole else {}
    checks = {
        "prefill_within_floor": pre_ok,
        "decode_within_floor": dec_ok,
        "f32_prefill_logits": f32_pre_ok, "f32_decode_logits": f32_dec_ok,
        "prefill_repeatable": all(r["prefill_first_equal"] for r in ranks),
        "prefill_launches": all(q["prefill"] == want["prefill"]
                                and one_pre in (None, q["prefill"])
                                for q in per),
        "decode_launches": all(q["decode"] == want["decode"]
                               and one_dec in (None, q["decode"])
                               for q in per),
        "train_launches": all(q["train"] == want["train"]
                              and one_train in (None, q["train"])
                              for q in per),
        "four_ranks": sorted(coords) == [(0, 0), (0, 1), (1, 0), (1, 1)],
        "gloo_on_the_card": all(r["backend"] == "gloo" for r in ranks),
        "library_not_rebuilt": card["library_not_rebuilt"],
        "twin_collectives": twin_held(ranks),
        **route_checks,
    }
    if (trains and cfg.vocab % MESH2_SHAPE[1] == 0
            and cfg.vocab != cfg.d_model):
        checks["train_twin_vocab_split"] = vocab_split_held(cfg, ranks)
    if trains:
        checks.update({
            "first_loss_within_floor": gaps["first_loss"]
            <= bounds["first_loss"],
            "first_grad_norm_within_floor": gaps["first_grad_norm"]
            <= bounds["first_grad_norm"],
            "f32_losses_grad_norms": f32_scalars_ok,
            "ranks_agree": all(r["losses"] == ranks[0]["losses"]
                               for r in ranks),
            "losses_finite": all(np.isfinite(r["losses"]).all()
                                 for r in ranks)})
    if cfg.family == "vlm":              # CACHE_AXES["img_kv"] on (2, 2)
        checks["image_kv_placed"] = all(
            r["img_kv_placements"] == ["Shard(dim=1)", "Shard(dim=3)"]
            for r in ranks)
    out = {"arch": cfg.name, "path": path, "ok": all(checks.values()),
           "checks": checks, "mesh": dict(zip(("data", "model"),
                                              MESH2_SHAPE)),
           "layers": cfg.n_layers, "reduced": None if prep["depth"] is None
           else f"n_layers -> {prep['depth']}",
           "rules": "DEFAULT_RULES", "ranks": 4, "device": ranks[0]["device"],
           "transport": {"backend": "gloo", "tensors": "cuda",
                         "host_staged": ranks[0]["staged"],
                         "why": "four ranks share one card: NCCL refuses "
                                "two ranks on one device"},
           "gaps": gaps, "floor": floor, "bounds": bounds,
           "held_against": "replay" if cfg.family == "moe" else
           "f32" if "f32_eval" in ref else "kernels",
           "routing": routing, "gaps_to_unmeshed_kernels": kernel_gaps,
           "floor_kernels_vs_plain": ref["floor_kernels_vs_plain"],
           "floor_bf16_vs_f32": ref.get("floor_bf16_vs_f32"),
           "floor_plain_vs_f32": ref.get("floor_plain_vs_f32"),
           "decode_steps": n_dec, "train_steps": int(trains),
           "losses_mesh": ranks[0]["losses"], "losses_unmeshed_first":
           ref.get("losses", [None])[0],
           "grad_norms_mesh": ranks[0]["grad_norms"],
           "grad_norms_unmeshed_first": ref.get("first_grad_norms"),
           "f32": {"depth": run.f32_depth,
                   "prefill_max_abs_err": f32_pre_err,
                   "decode_max_abs_err": f32_dec_err,
                   "tol": tol32, "scalars_tol": SMALL_F32_TOL,
                   "losses": ranks[0]["f32"]["losses"],
                   "losses_unmeshed": ref32.get("losses"),
                   "grad_norms": ranks[0]["f32"]["grad_norms"],
                   "grad_norms_unmeshed": ref32.get("grad_norms"),
                   "floor_kernels_vs_plain": ref32["floor_kernels_vs_plain"]},
           "ms_by_rank": [r["ms"] for r in ranks],
           "train_ms_is": "the one bf16 train step: cold, under "
                          "CommDebugMode" if trains else None,
           "one_device_mesh_ms": one, "slowdown": {
               k: max(r["ms"][k] for r in ranks) / one[k] for k in one},
           "placements": ranks[0]["placements"],
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
           "draw_peak_gb_by_rank": [r["draw_peak_gb"] for r in ranks],
           "card_used_gb_by_rank": [r["card_used_gb"] for r in ranks],
           "card": card, "seconds_by_rank": [r["seconds"] for r in ranks],
           "f32_seconds_by_rank": [r["seconds_f32"] for r in ranks],
           "draw_seconds_by_rank": [r["draw_s"] for r in ranks],
           "prepare_s": prep["seconds"],
           "per_prefill": {k: v for k, v in per[0]["prefill"].items() if v},
           "per_decode_step": {k: v for k, v in per[0]["decode"].items()
                               if v},
           "per_train_step": {k: v for k, v in per[0]["train"].items() if v}}
    for kind in ranks[0]["twin"]:
        emit("mesh2_collectives", arch=cfg.name, step=kind,
             measured_by_rank=[r["comm"][kind] for r in ranks],
             twin=[{k: r["twin"][kind][k] for k in ("counts", "bytes")}
                   for r in ranks],
             twin_s_by_rank=[r["twin_s"] for r in ranks],
             predicted_by_rank=[r["twin"][kind]["predicted"] for r in ranks],
             vocab_wide=ranks[0]["twin"][kind]["vocab_wide"],
             ms_by_rank=[r["ms"].get(kind) for r in ranks],
             peak_gb_by_rank=[r["peak_gb"] for r in ranks])
    emit("mesh2", **out)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    return ({"launches": launches, "per_prefill": per[0]["prefill"],
             "per_decode_step": per[0]["decode"],
             "per_train_step": per[0]["train"]},
            [k for k, v in checks.items() if not v])


def vocab_split_held(cfg, ranks: list) -> bool:
    """Whether no rank's train twin allocates a tensor of the global
    logits' shape, (B, S, V) or (B S, V), nor of a data rank's vocab-whole
    one, (B / data, S, V) or (B S / data, V): the loss
    (``kernels._local.vocab_on_shards``) takes each rank's block.  Held
    where "model" splits the vocab and V is not the model's width (there
    an activation has the shape)."""
    data = MESH2_SHAPE[0]
    wide = {(b, TRAIN_S, cfg.vocab) for b in (TRAIN_B, TRAIN_B // data)}
    wide |= {(b * TRAIN_S, cfg.vocab) for b in (TRAIN_B, TRAIN_B // data)}
    return all(not wide & set(map(tuple, r["twin"]["train"]["vocab_wide"]))
               for r in ranks)


def twin_held(ranks: list) -> bool:
    """Whether on every rank each tallied step's collectives equal, in
    calls and bytes by kind, the dry-run twin's count of that step on the
    rank's mesh (``mesh2_twins``), and a twin was counted for each."""
    return all(set(r["twin"]) == set(r["comm"]) and all(
        {k: r["comm"][step][k] for k in ("counts", "bytes")}
        == {k: twin[k] for k in ("counts", "bytes")}
        for step, twin in r["twin"].items()) for r in ranks)


def mesh2_variant_check(ref: dict, ranks: list, card: dict) -> tuple:
    """The checks of ``mesh2_variant`` (qwen3-1.7b decoding under
    ``MESH2_VARIANT``) from the ranks' results and the parent's
    references (``mesh2_variant_references``); emits its
    ``mesh2_collectives`` and ``mesh2_variant`` lines.  Held: the bf16
    logits of every step within ``FLOOR_FACTOR`` times the larger of the
    unmeshed kernels' gap to the plain versions and to the f32 weights
    (plus one bf16 ulp of the value), the f32 logits on the f32 cut at
    ``SMALL_F32_TOL``; the cache split along its sequence over "model", 4
    positions a rank, and the 8 steps' writes at positions 0-3 on the
    first "model" rank and 4-7 on the second; launches a step equal the
    expected ones (RMSNorm only); the first step's collectives on each
    rank equal the dry-run twin's count of it (``twin_held``).  Returns
    (the path's launches, the names of its failed checks)."""
    from repro_torch.configs import get_config
    cfg = get_config(MESH2_VARIANT_ARCH)
    B, V, n = 4, cfg.vocab, MESH_DECODE_STEPS
    floor = max(ref["floor"].values())
    bound = FLOOR_FACTOR * floor
    errs, ok = {}, {}
    for key, want, tol, dtype in (
            ("bfloat16", ref["decode"], bound, torch.bfloat16),
            ("float32", ref["f32_decode"], SMALL_F32_TOL, torch.float32)):
        ok[key], errs[key] = True, 0.0
        for i in range(n):
            got = mesh2_assemble([r[key]["decode"][i] for r in ranks],
                                 (B, 1, V))
            one, err = held_tol(got, want[i], tol, dtype)
            ok[key], errs[key] = ok[key] and one, max(errs[key], err)
    half = MESH2_VARIANT_MAX_SEQ // MESH2_SHAPE[1]
    written = {tuple(r["coord"]): r["bfloat16"]["written"] for r in ranks}
    per = [{k: v / n for k, v in r["bfloat16"]["launches"].items()}
           for r in ranks]
    want = expected_per_decode_step(cfg)
    checks = {
        "decode_within_floor": ok["bfloat16"],
        "f32_decode_logits": ok["float32"],
        "sequence_split_on_model": all(
            r[k]["cache_placements"][1] == "Shard(dim=2)"
            and r[k]["seq_block"] == [r["coord"][1] * half, half]
            for r in ranks for k in ("bfloat16", "float32")),
        "positions_on_both_model_ranks": all(
            w == list(range(c[1] * half, (c[1] + 1) * half))
            for c, w in written.items()),
        "decode_launches": all(q == want for q in per),
        "twin_collectives": twin_held([
            {"comm": {"decode": r["bfloat16"]["comm"]},
             "twin": {"decode": r["bfloat16"]["twin"]}} for r in ranks]),
    }
    out = {"arch": cfg.name, "path": MESH2_VARIANT_PATH,
           "ok": all(checks.values()), "checks": checks,
           "variant": MESH2_VARIANT, "max_seq": MESH2_VARIANT_MAX_SEQ,
           "decode_steps": n, "f32_depth": MESH2_RUNS[cfg.name].f32_depth,
           "max_abs_err": errs, "bound": bound, "floor": ref["floor"],
           "f32_tol": SMALL_F32_TOL, "written_by_coord": {
               f"{c[0]}{c[1]}": w for c, w in written.items()},
           "ms_by_rank": [r["bfloat16"]["ms"] for r in ranks],
           "peak_gb_by_rank": [r["bfloat16"]["peak_gb"] for r in ranks],
           "card_used_gb_by_rank": [r["card_used_gb"] for r in ranks],
           "staged": ranks[0]["staged"], "card_ranks_s": card["ranks_s"],
           "seconds_by_rank": [r["seconds"] for r in ranks],
           "per_decode_step": {k: v for k, v in per[0].items() if v}}
    emit("mesh2_collectives", arch=cfg.name, step="decode",
         variant=MESH2_VARIANT,
         measured_by_rank=[r["bfloat16"]["comm"] for r in ranks],
         twin=[{k: r["bfloat16"]["twin"][k] for k in ("counts", "bytes")}
               for r in ranks],
         predicted_by_rank=[r["bfloat16"]["twin"]["predicted"]
                            for r in ranks],
         ms_by_rank=[r["bfloat16"]["ms"] for r in ranks],
         peak_gb_by_rank=[r["bfloat16"]["peak_gb"] for r in ranks])
    emit("mesh2_variant", **out)
    launches = {k: sum(r["bfloat16"]["launches"][k] for r in ranks)
                for k in ranks[0]["bfloat16"]["launches"]}
    return ({"launches": launches, "per_decode_step": per[0]},
            [k for k, v in checks.items() if not v])


def held_tol(got, want, tol: float = SMALL_F32_TOL,
             dtype=torch.float32, rtol=None) -> tuple:
    """(ok, max abs error), one sequence at a time on the card: f32 within
    ``tol`` absolute and ``rtol`` (default ``tol``) relative; bf16 within
    ``tol`` plus one bf16 ulp of the value (``close_enough``: the logits
    are bf16, so a gap is a whole number of ulps of its element)."""
    ok, err = True, 0.0
    for g, w in zip(got, want):
        g, w = g.cuda(), w.cuda()
        if dtype == torch.float32:
            g, w = g.float(), w.float()
            one = bool(torch.allclose(g, w, atol=tol,
                                      rtol=tol if rtol is None else rtol))
            one_err = float((g - w).abs().max())
        else:
            one, one_err = close_enough(g, w, tol, dtype)
        ok, err = ok and one, max(err, one_err)
    return ok, err


# --------------------------------------------------------------- phase 6e

SIM_SCALE, SIM_SEED = 0.25, 0
SIM_CHAOS_PROCS = 2
SIM_PROBE_S = 0.25         # virtual seconds between chaos probes
SIM_RESPAWN_BOUND_S = 1.0  # five of the supervisor's 0.2 s polls


def load_example(name: str):
    """A module of ``examples/`` by file name."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def chaos_sim_run(chaos_events=(), window_from=None,
                  strike_at=None) -> dict:
    """tests/test_chaos.py's end-to-end world (the paper suite at 0.15,
    jobs 2, 8 and 9, a cache of 35 % of the data) through ``ClusterSim``
    over a process-driver client of ``SIM_CHAOS_PROCS`` workers: the
    result, the kernel's stats at ``window_from`` and at the end, the
    fault and client stats, the workers' exit codes.  From ``strike_at``
    a probe runs every ``SIM_PROBE_S`` virtual seconds; the first one that
    finds degraded reads waits on the wall clock until every kill has its
    respawn and every shard is up (``barrier``: its virtual time, wall
    wait and the degraded reads before it).  The respawn runs on the wall
    clock (the supervisor polls every 0.2 s) while the trace runs on
    virtual time, and reads that find the shard down are served from the
    store without being admitted, so without the wait the virtual length
    of the outage, and the next epoch's hits, would follow the host's
    speed (PERF.md §6); with it, the outage spans the reads up to the
    first probe after the first degraded one, on any host whose respawn
    outlasts that probe step."""
    from repro_torch.core import CacheConfig, open_cache
    from repro_torch.core.faults import SHARD_UP
    from repro_torch.core.types import MB
    from repro_torch.sim import ClusterSim, make_paper_suite
    from repro_torch.storage import RemoteStore
    suite = make_paper_suite(scale=0.15, seed=0, job_filter=[2, 8, 9])
    store = RemoteStore()
    for ds in suite.datasets.values():
        store.add(ds)
    cap = int(0.35 * suite.total_bytes())
    cfg = CacheConfig(min_share=4 * MB, rebalance_quantum=4 * MB,
                      window=40, reanalyze_every=20, node_cap=500)
    client = open_cache(store, cap, cfg=cfg, driver="process",
                        n_procs=SIM_CHAOS_PROCS, rpc_timeout_s=15.0)
    out = {"snaps": {}, "barrier": None}

    def recovered() -> bool:
        kinds = [e["kind"] for e in client.fault_stats()["events"]]
        return kinds.count("respawn") >= kinds.count("kill") and all(
            st == SHARD_UP for st in client.shard_states())

    def barrier(sim):
        degraded = client.client_stats.snapshot()["degraded_reads"]
        if out["barrier"] is not None or not degraded:
            return
        t0 = time.monotonic()
        while not recovered():
            if time.monotonic() - t0 > 60:
                raise AssertionError("no respawn within 60 s")
            time.sleep(0.01)
        out["barrier"] = {"at": sim.now, "wait_s": time.monotonic() - t0,
                          "degraded_reads": degraded}
    try:
        sim = ClusterSim(suite, client, chaos_events=list(chaos_events))
        if window_from is not None:
            sim.at(window_from, lambda s: out["snaps"].__setitem__(
                "w", s.engine.stats.snapshot()))
        if strike_at is not None:
            n = int((window_from - strike_at) / SIM_PROBE_S)
            for k in range(1, n + 1):
                sim.at(strike_at + k * SIM_PROBE_S, barrier)
        out["res"] = sim.run()
        out["snaps"]["end"] = client.stats.snapshot()
        out["fault"] = client.fault_stats()
        out["cstats"] = client.client_stats.snapshot()
        procs = [ch.proc for ch in client.engine._channels]
    finally:
        client.close()
    out["exitcodes"] = [p.exitcode for p in procs]
    return out


def host_rss_gb() -> float:
    """This process's resident host memory (what a fork's page tables
    copy)."""
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f
                  if line.startswith("VmRSS:"))
    return kb / 1e6


def window_chr(snaps) -> float:
    s0, s1 = snaps["w"], snaps["end"]
    hits = s1["hits"] - s0["hits"]
    total = hits + s1["misses"] - s0["misses"]
    return hits / total if total else 0.0


def phase_sim() -> dict:
    """Host phase, in this process (which holds a CUDA context): the paper's
    mixed-cluster scenario on the port's simulator
    (examples/mixed_cluster_torch.py) at ``SIM_SCALE``, seed 0: the 18
    jobs through igtcache, juicefs and nocache, then igtcache again.
    Checks (tests/test_sim.py's): every job finishes, nocache's CHR is 0,
    both caches' average JCT is below nocache's, and the second igtcache
    run gives the first's ``jct`` and ``hit_ratio``.  Then tests/
    test_chaos.py's end-to-end recipe on a process-driver client (its shard
    workers forked from this process): a run without faults, and one with
    a ``kill`` strike at a third of its makespan, which waits on the wall
    clock for the worker at the first probe after the first degraded read
    (``chaos_sim_run``); the same jobs complete, reads were served
    degraded before that wait, the driver respawns the worker once within
    ``SIM_RESPAWN_BOUND_S``, every shard ends up, and the CHR of the last
    third lies within 0.05 of the fault-free run's.  The
    simulator's numbers depend on the interpreter's string hashing (set
    order), so they vary with ``PYTHONHASHSEED`` and are compared within
    this run only."""
    import hashlib
    import multiprocessing
    import os
    from repro_torch.core.faults import SHARD_UP
    mc = load_example("mixed_cluster_torch")
    t0 = time.perf_counter()
    suite, store, cap, cfg = mc.build(SIM_SCALE, SIM_SEED)
    build_s = time.perf_counter() - t0
    # the workload itself, to set beside another machine's
    digest = hashlib.sha256(repr([(j.job_id, j.submit_time, j.steps)
                                  for j in suite.jobs]).encode()).hexdigest()
    results, rows = {}, {}
    for name in mc.BUNDLES + ("igtcache",):
        res, wall = mc.simulate(suite, store, cap, cfg, name)
        key = name if name not in results else f"{name}_again"
        results[key] = res
        rows[key] = {"avg_jct_s": res.avg_jct, "chr": res.hit_ratio,
                     "makespan_s": res.makespan,
                     "link_utilization": res.link_utilization,
                     "link_bytes": res.link_bytes, "jobs": len(res.jct),
                     "wall_s": wall}
    ig, ju, nc = (results[k] for k in mc.BUNDLES)
    jobs = {j.job_id for j in suite.jobs}
    base = chaos_sim_run()["res"]
    kill_at = base.makespan / 3.0
    window_from = 2.0 * base.makespan / 3.0
    base2 = chaos_sim_run(window_from=window_from, strike_at=kill_at)
    t1 = time.perf_counter()
    run = chaos_sim_run(chaos_events=[(kill_at, "kill", 0)],
                        window_from=window_from, strike_at=kill_at)
    chaos_s = time.perf_counter() - t1
    res, fault = run["res"], run["fault"]
    chr_base = window_chr(base2["snaps"])
    chr_chaos = window_chr(run["snaps"])
    respawns = [e for e in fault["events"] if e["kind"] == "respawn"]
    checks = {
        "all_jobs_finish": all(set(r.jct) == jobs and all(
            v > 0 for v in r.jct.values()) for r in results.values()),
        "eighteen_jobs": len(jobs) == 18,
        "nocache_chr_0": nc.hit_ratio == 0.0,
        "caches_beat_nocache": ig.avg_jct < nc.avg_jct
        and ju.avg_jct < nc.avg_jct,
        "igtcache_deterministic":
        results["igtcache_again"].jct == ig.jct
        and results["igtcache_again"].hit_ratio == ig.hit_ratio,
        "chaos_same_jobs": set(res.jct) == set(base2["res"].jct)
        and bool(res.jct),
        "chaos_struck": [e["kind"] for e in res.chaos_log] == ["kill"],
        "chaos_one_respawn": len(respawns) == 1,
        "chaos_degraded_before_barrier": run["barrier"] is not None
        and run["barrier"]["degraded_reads"] > 0,
        "chaos_respawn_in_bound": all(e["recovery_s"] <= SIM_RESPAWN_BOUND_S
                                      for e in respawns),
        "chaos_shards_up": all(s["state"] == SHARD_UP
                               for s in fault["shards"].values()),
        "chaos_window_chr": abs(chr_base - chr_chaos) <= 0.05,
        "chaos_workers_exited_0": run["exitcodes"]
        == [0] * SIM_CHAOS_PROCS,
        "no_children": multiprocessing.active_children() == [],
    }
    out = {"ok": all(checks.values()), "checks": checks,
           "scale": SIM_SCALE, "seed": SIM_SEED, "jobs": len(jobs),
           "data_bytes": suite.total_bytes(), "cache_bytes": cap,
           "build_s": build_s, "bundles": rows,
           "igtcache_vs_juicefs_jct": 1 - ig.avg_jct / ju.avg_jct,
           "juicefs_vs_nocache_jct": 1 - ju.avg_jct / nc.avg_jct,
           "suite_sha256": digest, "python": sys.version.split()[0],
           "numpy": np.__version__,
           "pythonhashseed": os.environ.get("PYTHONHASHSEED"),
           "chaos": {"workers": SIM_CHAOS_PROCS, "kill_at": kill_at,
                     "window_from": window_from,
                     "probe_s": SIM_PROBE_S,
                     "recovery_s": [e["recovery_s"] for e in respawns],
                     "recovery_bound_s": SIM_RESPAWN_BOUND_S,
                     "barrier": run["barrier"],
                     "host_rss_gb": host_rss_gb(),
                     "makespan_base": base.makespan,
                     "makespan_chaos": res.makespan,
                     "window_chr_base": chr_base,
                     "window_chr_chaos": chr_chaos,
                     "degraded_reads": run["cstats"]["degraded_reads"],
                     "respawns": len(respawns),
                     "fault_events": [e["kind"] for e in fault["events"]],
                     "worker_exitcodes": run["exitcodes"],
                     "wall_s": chaos_s}}
    emit("sim", **out)
    if not out["ok"]:
        raise AssertionError(f"sim phase failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return out


# --------------------------------------------------------------- phase 6f

# The configurations one card cannot hold, lowered only (a one-device mesh,
# chip_smoke's own shapes): qwen3-moe's 4 x 1024 train step (its AdamW
# state alone is 244 GB) and llama-3.2-vision-90b's prefill and decode at
# all 100 layers (177 GB of bf16 weights).
PAPER_CELLS = (("qwen3-moe-30b-a3b", "train", TRAIN_S, TRAIN_B),
               (VLM, "prefill", 1024, 4),
               (VLM, "decode", 512, 4))
DRYRUN_TIMEOUT_S = 900


def paper_cells() -> None:
    """Print one JSON line for each of ``PAPER_CELLS``: its step lowered on
    a 1 x 1 mesh (``abstract_mesh(local=True)``) at full width and depth,
    traced on ``meta`` tensors, with its memory and roofline on paper.
    Runs on the host alone (``start_dryrun`` starts it in a process of its
    own, with no card visible)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_step
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.models.config import ShapeSpec
    from repro_torch.sharding import DEFAULT_RULES
    for arch, kind, S, B in PAPER_CELLS:
        cfg = get_config(arch)
        shape = ShapeSpec(f"chip_{kind}", S, B, kind)
        compiled = lower_step(cfg, shape, abstract_mesh(local=True),
                              DEFAULT_RULES, "full").compile()
        r = roofline_of(cfg, shape, compiled)
        print(json.dumps({"arch": arch, "step": kind, "shape": [B, S],
                          "n_layers": cfg.n_layers, **r}), flush=True)


def start_dryrun() -> dict:
    """Start the dry-run on the host, beside the card's phases, in two
    processes with no card visible (``CUDA_VISIBLE_DEVICES`` empty, one
    thread each, at a lower scheduling priority, ``nice`` 10: the card's
    phases are host-bound and set the script's time): ``python -m
    repro_torch.launch.dryrun --all --mesh both`` into a temporary
    directory, and ``paper_cells``.  A thread a process records when it
    ends (``ended``: seconds from the start)."""
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="repro_torch_dryrun"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs, ended, watchers = {}, {}, []
    t0 = time.perf_counter()

    def watch(name, proc):
        proc.wait()
        ended[name] = time.perf_counter() - t0
    for name, argv in (
            ("sweep", ["-m", "repro_torch.launch.dryrun", "--all", "--mesh",
                       "both", "--out", str(out / "dryrun_results.json")]),
            ("paper", ["-c", "import chip_smoke; chip_smoke.paper_cells()"])):
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, *argv], cwd=str(ROOT), env=env, stdout=log,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10)), log)
        watchers.append(threading.Thread(target=watch, daemon=True,
                                         args=(name, procs[name][0])))
        watchers[-1].start()
    return {"dir": out, "procs": procs, "ended": ended,
            "watchers": watchers}


def stop_dryrun(bg) -> None:
    """Kill whatever of ``start_dryrun``'s processes still runs."""
    for proc, log in (bg or {}).get("procs", {}).values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def phase_dryrun(bg: dict) -> dict:
    """Host phase: wait for ``start_dryrun``'s processes, then run
    ``python -m repro_torch.roofline.report`` on the sweep's results.
    Checks: both exit 0, the sweep recorded every (arch, shape, mesh) cell
    ``ok`` or ``skipped`` (the full-attention configs skip ``long_500k``),
    and the report's tables came out.  Prints one line a cell
    (``dominant_adj``, ``step_ms_adj``, ``bytes_per_device_gb``,
    ``fits_hbm_80g``, from the report's enriched rows) and one a
    ``PAPER_CELLS`` step.  The sweep's wall time runs beside the card's
    phases: ``sweep_wall_s`` and ``paper_wall_s`` are when each process
    ended (``start_dryrun``'s threads), ``wait_s`` what this phase waited
    for them."""
    t0 = time.perf_counter()
    rcs = {}
    for name, (proc, log) in bg["procs"].items():
        rcs[name] = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        log.close()
    for w in bg["watchers"]:
        w.join()
    wait_s = time.perf_counter() - t0
    out = bg["dir"]
    results = out / "dryrun_results.json"
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.report", str(results)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                 PYTHONPATH=str(ROOT / "src")))
    rcs["report"] = report.returncode
    rows = (json.loads(results.with_suffix(".enriched.json").read_text())
            if report.returncode == 0 else [])
    for r in rows:
        emit("dryrun_cell", **{k: r.get(k) for k in (
            "arch", "shape", "mesh", "status", "dominant", "dominant_adj",
            "step_ms_adj", "hlo_gflops", "hlo_gbytes", "coll_gbytes",
            "bytes_per_device_gb", "fits_hbm_80g")},
             **{k: (r.get("memory") or {}).get(v) for k, v in (
                 ("temp", "temp_size_in_bytes"),
                 ("temp_by_depth", "temp_by_depth"))})
    paper = [json.loads(line) for line in
             (out / "paper.log").read_text().splitlines()
             if line.startswith("{")]
    for line in paper:
        emit("dryrun_paper", **line)
    from repro_torch.configs import CONFIGS, SHAPES
    cells = {(r["arch"], r["shape"], r["mesh"]) for r in rows}
    want = {(a, s, m) for a in CONFIGS for s in SHAPES
            for m in ("single", "multi")}
    checks = {
        "exit_codes": all(rc == 0 for rc in rcs.values()),
        "every_cell": cells == want and len(rows) == len(want),
        "ok_or_skipped": bool(rows) and all(
            r.get("status") in ("ok", "skipped") for r in rows),
        "skips_are_long_500k": all(
            r["shape"] == "long_500k" for r in rows
            if r.get("status") == "skipped"),
        "tables": "### Roofline — single mesh" in report.stdout
        and "### Roofline — multi mesh" in report.stdout,
        "paper_cells": len(paper) == len(PAPER_CELLS),
    }
    summary = {"ok": all(checks.values()), "checks": checks, "rcs": rcs,
               "cells": len(rows),
               "ok_cells": sum(r.get("status") == "ok" for r in rows),
               "skipped": sum(r.get("status") == "skipped" for r in rows),
               "sweep_wall_s": bg["ended"]["sweep"],
               "paper_wall_s": bg["ended"]["paper"], "wait_s": wait_s,
               "trace_s_sum": sum(r.get("trace_s", 0) for r in rows),
               "count_s_sum": sum(r.get("count_s", 0) for r in rows),
               "dominant": dict(Counter(r["dominant"] for r in rows
                                        if r.get("status") == "ok")),
               "dominant_adj": dict(Counter(
                   r.get("dominant_adj") for r in rows
                   if r.get("status") == "ok"))}
    emit("dryrun", **summary)
    if not summary["ok"]:
        tail = {n: (out / f"{n}.log").read_text()[-2000:]
                for n in bg["procs"]}
        raise AssertionError(f"dryrun phase failed: "
                             f"{[k for k, v in checks.items() if not v]}; "
                             f"{tail}; {report.stderr[-2000:]}")
    return summary


# --------------------------------------------------------------- phase 7

def phase_profile(cfg, params) -> None:
    """Where the time goes: one traced prefill and one traced decode step
    (torch.profiler), device time by kernel and the device's busy share of
    the host's wall time."""
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.serve.serve_step import make_prefill, make_serve_step
    inputs = model_inputs(cfg, 4, 1024, 2)
    state = init_decode_state(cfg, 4, 512, device="cuda")
    feed = {k: v[:, :1] for k, v in inputs.items() if k != "img_embeds"}
    prefill, step = make_prefill(cfg, "cuda"), make_serve_step(cfg, "cuda")
    for what, fn in (("prefill", lambda: prefill(params, **inputs)),
                     ("decode_step", lambda: step(params, state, **feed))):
        fn()
        torch.cuda.synchronize()
        profile_once(cfg.name, what, fn)


def profile_once(arch: str, what: str, fn, top_n: int = 10) -> None:
    """One traced run of ``fn`` (already warm): device time by kernel, the
    port's kernels summed by name, and the device's busy share of the
    host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    top = sorted(rows, key=lambda r: -r[1])[:top_n]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])[:5]
    # By substring: "ssd_" is every SSD kernel, the backward's three
    # ("ssd_chunk_bwd") included, and an older checkout's two;
    # "rmsnorm" is every RMSNorm kernel, backward ("rmsnorm_bwd", and its
    # dw column sums "rmsnorm_dw") included; "flash_bwd" includes the D pass.
    ours = {k: [sum(ms for name, ms, _ in rows if k in name),
                sum(n for name, _, n in rows if k in name)]
            for k in ("ssd_", "ssd_chunk_bwd", "flash_fwd", "flash_bwd",
                      "rmsnorm", "rmsnorm_bwd", "rmsnorm_dw")}
    emit("profile", arch=arch, what=what, wall_ms=wall_ms,
         device_ms=device_ms,
         busy_share=device_ms / wall_ms if wall_ms else None,
         kernels=len(rows), ports_kernels_ms_launches=ours,
         top=[[name[:80], ms, n] for name, ms, n in top],
         host_top=[[name[:60], ms, n] for name, ms, n in host])


# --------------------------------------------------------------- main

def init_model(arch: str, depth=None):
    """The model at full width, random weights from seed 0 on the card (a
    vlm's gates opened), on its first ``depth`` layers (default: DEPTH's,
    else all)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    depth = depth or DEPTH.get(arch, cfg.n_layers)
    reduced = (f"n_layers {cfg.n_layers} -> {depth}"
               if depth < cfg.n_layers else None)
    cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    params = open_gates(cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    emit("init", arch=cfg.name, params=n_params, reduced=reduced,
         gb=n_params * 2 / 1e9, seconds=time.perf_counter() - t0)
    return cfg, params


def run_model(arch: str) -> dict:
    """One model's main path (prefill, and serving where the model is
    served), with the launch counts set to 0 just before it and read just
    after; then its checks, its profile and, last, its f32 pairs (which
    free the bf16 weights)."""
    cfg, params = init_model(arch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                       # this model's main path starts here
    pre = phase_prefill(cfg, params)
    srv = phase_serve(cfg, params) if arch in SERVED else None
    launches = counts()                  # ... and ends here
    check_prefill(cfg, params, pre)
    if srv is not None:
        check_serve(cfg, params, srv)
        state = srv.pop("engine").state
    else:
        state = check_decode(cfg, params)
    if cfg.family == "vlm":              # the engine's state has no image
        state = check_decode(cfg, params,
                             img_embeds=pre["inputs"]["img_embeds"])
    if arch in PROFILED:
        phase_profile(cfg, params)
    check_f32(cfg, params, pre["inputs"], state)
    del params, state
    torch.cuda.empty_cache()
    return {"launches": launches, "per_prefill": pre["launches"],
            "serve": srv["launches"] if srv is not None else None,
            "per_decode_step": None if srv is None else {
                k: v / max(1, srv["steps"])
                for k, v in srv["launches"].items()},
            "ms_per_decode_step": None if srv is None
            else srv["seconds"] / max(1, srv["steps"]) * 1e3}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    dev = phase_device()
    if "--profile-only" in sys.argv[1:]:
        named = [a for a in sys.argv[1:] if not a.startswith("--")]
        unknown = set(named) - set(ARCHS)
        if unknown:
            raise SystemExit(f"chip_smoke: unknown models {sorted(unknown)}")
        phase_build()
        for arch in PROFILED:
            if named and arch not in named:
                continue
            cfg, params = init_model(arch)
            phase_profile(cfg, params)
            del params
            torch.cuda.empty_cache()
        for arch in TRAIN_ARCHS:
            if named and arch not in named:
                continue
            cfg, params = init_model(arch)
            profile_train(cfg, params, random_batch(cfg))
            del params
            torch.cuda.empty_cache()
        return 0
    if "--kernels-only" in sys.argv[1:]:
        phase_kernels(phase_build())
        return 0
    bg = start_dryrun()                  # host processes, beside the card
    try:
        cases = phase_kernels(phase_build())
        for arch in ARCHS:
            small_model_check(arch)
        for arch in TRAIN_ARCHS + GRAD_ARCHS:
            small_train_check(arch)
        launcher_check()
        paths = {arch: run_model(arch) for arch in ARCHS}
        for arch in TRAIN_ARCHS:
            paths[f"train/{arch}"] = run_train(arch)
        for arch in GRAD_ARCHS:
            paths[f"train/{arch}"] = run_grads(arch)
        paths[MESH] = run_mesh(paths)    # destroys its process group
        paths.update(run_mesh2(paths))  # spawned ranks, none left after
        paths[UNIFIED] = run_unified(paths)  # ... before these fork workers
        phase_cache()
        phase_sim()
        phase_dryrun(bg)
    finally:
        stop_dryrun(bg)

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
                arch: ({"path": p["launches"][name],
                        "per_train_step": p["per_train_step"][name]}
                       if arch.startswith("train/") else
                       {"path": p["launches"][name],
                        "per_train_step": p["per_train_step"][name],
                        "per_decode_step": p["per_decode_step"][name]}
                       if arch == UNIFIED else
                       {"path": p["launches"][name],
                        "per_decode_step": p["per_decode_step"][name]}
                       if arch == MESH2_VARIANT_PATH else
                       {"path": p["launches"][name],
                        "per_prefill": p["per_prefill"][name],
                        "per_decode_step": p["per_decode_step"][name],
                        "per_train_step": p["per_train_step"][name]}
                       if arch == MESH or arch in MESH2_PATHS else
                       {"path": p["launches"][name],
                        "per_prefill": p["per_prefill"][name],
                        "serve": None if p["serve"] is None
                        else p["serve"][name]})
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
