"""Serve an LM with batched requests on the PyTorch port (``repro_torch``).

The same CLI as ``examples/serve_llm.py``, plus ``--device`` (default
``cuda``; pass ``cpu`` to run the plain PyTorch path) and ``--full`` (the
full configuration instead of ``reduced_config``).  ``--arch`` takes a
ported family's config: dense (``qwen3-1.7b``, ...), hybrid
(``zamba2-1.2b``) or ssm (``mamba2-370m``).  The port has no cache engine of
its own yet, so this example serves without RAG retrieval.

    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu
    PYTHONPATH=src python examples/serve_llm_torch.py --device cpu --arch zamba2-1.2b
    PYTHONPATH=src python examples/serve_llm_torch.py --full     # on a GPU
    PYTHONPATH=src python examples/serve_llm_torch.py --full --arch mamba2-370m
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import Request, ServingEngine


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of reduced_config")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))

    srv = ServingEngine(params, cfg, batch=args.batch, max_seq=128,
                        device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(3, 8),
                              dtype=np.int32)
        srv.submit(Request(rid, prompt, max_new=args.max_new))
    done = srv.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    toks = sum(len(r.output) for r in done)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "CPU")
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s on {where}; {srv.steps} decode steps)")
    for r in done[:4]:
        print(f"  req{r.rid}: tokens {r.output}")
    print("retrieval: off (the port has no cache engine of its own yet)")


if __name__ == "__main__":
    main()
