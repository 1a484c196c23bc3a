#!/usr/bin/env python3
"""Time versions of the SSD chunk kernel side by side on one GPU.

    python3 examples/ssd_chunk_bench.py [--source FILE ...]

Each ``--source`` is a version of ``src/repro_torch/csrc/ssd_chunk.cu`` (the
default is the repo's own) that exports ``ssd_chunk_fwd`` with the repo's
signature.  Each is built by ``_build.build`` from a copy of ``csrc/`` with
that file in place of the repo's.  At zamba2-1.2b's and mamba2-370m's
prefill shapes (b4 c4 l256, h64 n64 and h32 n128, p64, f32, on
``chip_smoke.py``'s inputs) each version is held against ``ssd_chunk_ref``
and timed as ``chip_smoke.py`` times a kernel (cold L2, median of 20), the
versions in turns: two rounds, the second in reverse order.  Prints the
card's name and power limit, then one JSON line per (shape, version, round).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import TOL, ssd_inputs, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

SHAPES = [(4, 4, 256, 64, 64, 64), (4, 4, 256, 32, 64, 128)]
TURNS = 2


def load(k: int, source: Path):
    """``ssd_chunk_fwd`` of the library built with ``source`` in place of the
    repo's ``ssd_chunk.cu``."""
    csrc = ROOT / "build" / "ssd_chunk_bench" / f"v{k}"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    shutil.copy(source, csrc / "ssd_chunk.cu")
    fn = ctypes.CDLL(str(_build.build(csrc))).ssd_chunk_fwd
    fn.argtypes, fn.restype = _build.SIGNATURES["ssd_chunk_fwd"]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", type=Path,
                    help="a version of csrc/ssd_chunk.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_chunk_bench: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    sources = args.source or [_build.CSRC / "ssd_chunk.cu"]
    fns = {f"{k}:{src.name}": load(k, src) for k, src in enumerate(sources)}
    from repro_torch.kernels.ssd import ssd_chunk_ref
    tol = TOL[torch.float32]["ssd_chunk"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    ok = True
    for b, c, l, h, p, n in SHAPES:
        x, a, B, C = ssd_inputs((b, c, l, h, p), (b, c, l, h), (b, c, l, n),
                                n ** -0.5, gen)
        y_ref, st_ref = ssd_chunk_ref(x, a, B, C)
        for turn in range(TURNS):
            for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
                y = torch.empty_like(x)
                st = torch.empty((b, c, h, p, n), device="cuda")

                def run(fn=fns[name]):
                    return fn(x.data_ptr(), a.data_ptr(), B.data_ptr(),
                              C.data_ptr(), y.data_ptr(), st.data_ptr(),
                              b * c, l, h, p, n,
                              torch.cuda.current_stream().cuda_stream)
                if run():
                    raise RuntimeError(f"{name}: launch refused")
                torch.cuda.synchronize()
                err = max(float((y - y_ref).abs().max()),
                          float((st - st_ref).abs().max()))
                ok = ok and err <= tol
                print(json.dumps({"shape": [b, c, l, h, p, n],
                                  "version": name, "turn": turn,
                                  "max_abs_err": err, "tol": tol,
                                  "ms": time_ms(run, flush)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
