#!/usr/bin/env python3
"""Time the SSD chunk backward with some of its main kernel's phases left
out, on one GPU: where the time of ``csrc/ssd_chunk_bwd.cu`` goes.

    python3 examples/ssd_bwd_phases_torch.py

``ssd_chunk_bwd_kernel`` runs three phases, the bits of ``SSD_BWD_PHASES``:
1 forms Gᵀ, 2 is the main loop over (head, i-tile), 4 the state terms.  Each
mask below is built from a copy of ``csrc/`` whose ``ssd_chunk_bwd.cu``
starts with ``#define SSD_BWD_PHASES <mask>`` (the set-up, the dG write-out
and the two finishing kernels always run; the results of a partial mask are
wrong and are not checked).  At zamba2-1.2b's and mamba2-370m's train shapes
(b4 c4 l256 p64; h64 n64 and h32 n128; f32, ``chip_smoke.py``'s inputs)
each build's whole call (three launches) is timed as ``chip_smoke.py`` times
a kernel (cold L2, median of 20), in two rounds, the second in reverse
order.  A phase's time is the full mask's less the mask without it (the
means of the two rounds).  Prints
the card's name and power limit, then one JSON line per shape.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import ssd_inputs, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd.kernel import bwd_plan  # noqa: E402

SHAPES = [(4, 4, 256, 64, 64, 64), (4, 4, 256, 32, 64, 128)]
MASKS = {"all": 7, "no_G": 6, "no_main": 5, "no_state": 3, "main": 2,
         "state": 4, "G": 1, "none": 0}


def load(name: str, mask: int):
    """``ssd_chunk_bwd`` of a library whose backward runs the phases in
    ``mask``."""
    csrc = ROOT / "build" / "ssd_bwd_phases" / name
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    path = csrc / "ssd_chunk_bwd.cu"
    path.write_text(f"#define SSD_BWD_PHASES {mask}\n" + path.read_text())
    fn = ctypes.CDLL(str(_build.build(csrc))).ssd_chunk_bwd
    fn.argtypes, fn.restype = _build.SIGNATURES["ssd_chunk_bwd"]
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bwd_phases: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    fns = {name: load(name, mask) for name, mask in MASKS.items()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for b, c, l, h, p, n in SHAPES:
        x, a, B, C = ssd_inputs((b, c, l, h, p), (b, c, l, h), (b, c, l, n),
                                n ** -0.5, gen)
        dy = torch.randn(b, c, l, h, p, generator=gen, device="cuda")
        ds = torch.randn(b, c, h, p, n, generator=gen, device="cuda")
        pl = bwd_plan(b, c, l, h, p, n)
        ws = torch.empty(pl.ws_floats, dtype=torch.float32, device="cuda")
        grads = [torch.empty_like(t) for t in (x, a, B, C)]
        ptrs = [t.data_ptr() for t in (x, a, B, C, dy, ds, *grads)]
        ms = {}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                def call(fn=fns[name]):
                    err = fn(*ptrs, ws.data_ptr(), pl.ws_floats, b * c, l, h,
                             p, n, _build.stream_ptr(x))
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms.setdefault(name, []).append(time_ms(call, flush))
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        print(json.dumps({"shape": [b, c, l, h, p, n], "ms": ms, "phase_ms": {
            "G": mean["all"] - mean["no_G"],
            "main": mean["all"] - mean["no_main"],
            "state": mean["all"] - mean["no_state"],
            "rest": mean["none"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
