"""End-to-end training driver (torch): IGTCache-fed data pipeline -> train
step -> checkpoint/restart — the paper's cache as the data plane of an LM
trainer, on one device.

Counterpart of ``repro.launch.train`` with the same CLI plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).  Example (CPU,
reduced model):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 100 --batch 4 --seq 256 --device cpu

``--arch`` takes any architecture (e.g. ``zamba2-1.2b``, ``mamba2-370m``,
``granite-moe-3b-a800m``, ``musicgen-large``, ``llama-3.2-vision-90b``);
as in the reference, every family trains on the pipeline's token ids
(audio through its ``embed`` table, vlm with no image).

Every batch is read through the port's own cache client
(``core.bundle_client``) by ``CachedTokenPipeline``, which yields NumPy; the
loop moves it to the device.  The model is initialised from seed 0 on the
device (a full-width model is drawn on the card).  The step runs through a
one-device mesh (``make_local_mesh(device)``), as the reference's does on one
device; the one-rank process group that the mesh starts is released when the
run ends.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import resolve_device
from ..configs import get_config, reduced_config
from ..core import CacheConfig, bundle_client
from ..core.types import MB
from ..data.pipeline import CachedTokenPipeline, make_token_dataset
from ..models.transformer import init_params
from ..storage.object_store import RemoteStore
from ..train.checkpoint import CheckpointManager
from ..train.fault import PreemptionGuard, StragglerDetector
from ..train.optimizer import AdamWConfig, init_state
from ..train.train_step import make_train_step
from .mesh import make_local_mesh, release_local_mesh

N_SHARDS = 8


def build_pipeline(store: RemoteStore, vocab: int, *, batch: int, seq: int,
                   steps: int, cache_mb: int, cache_bundle: str):
    """The synthetic token corpus in ``store`` and the pipeline that reads it
    through a ``cache_bundle`` client of ``cache_mb`` MB (threaded prefetch),
    as the reference launcher builds them.  Returns (pipeline, client)."""
    shard_bytes = max(8 * MB, batch * (seq + 1) * 4 * steps // N_SHARDS)
    store.add(make_token_dataset("train_corpus", N_SHARDS, shard_bytes))
    cache_cfg = CacheConfig(min_share=16 * MB, rebalance_quantum=16 * MB,
                            rebalance_period=10.0)
    client = bundle_client(cache_bundle, store, cache_mb * MB, cfg=cache_cfg,
                           executor="threaded")
    pipe = CachedTokenPipeline(store, client, "train_corpus", seq_len=seq,
                               batch=batch, vocab=vocab)
    return pipe, client


def to_device(batch_np, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--cache-mb", type=int, default=256)
    ap.add_argument("--cache-bundle", default="igtcache",
                    help="igtcache | juicefs | prefetch_none | ...")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)

    # ---- the paper's technique as the data plane -------------------------
    store = RemoteStore()
    pipe, client = build_pipeline(store, cfg.vocab, batch=args.batch,
                                  seq=args.seq, steps=args.steps,
                                  cache_mb=args.cache_mb,
                                  cache_bundle=args.cache_bundle)
    engine = client.engine

    # ---- model / optimizer ------------------------------------------------
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    opt_state = init_state(params)
    mesh = make_local_mesh(device)
    step_fn = make_train_step(cfg, opt_cfg, mesh, None, remat="full")

    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        (params, opt_state), extra = ckpt.restore((params, opt_state))
        start_step = extra.get("step", ckpt.latest_step())
        print(f"[train] resumed from step {start_step}")

    straggler = StragglerDetector()

    def on_preempt():
        ckpt.save(step, (params, opt_state), {"step": step})
        print(f"[train] preempted — checkpointed step {step}")

    step = start_step
    t_start = time.time()
    losses = []
    with PreemptionGuard(on_preempt):
        it = pipe.batches(epochs=1000)
        for step in range(start_step, args.steps):
            batch = to_device(next(it), device)
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            straggler.record(0, time.time() - t0)
            if (step + 1) % args.log_every == 0:
                s = engine.snapshot()
                print(f"[train] step {step+1:5d} loss {loss:7.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"CHR {s['hit_ratio']:.3f} "
                      f"({time.time()-t0:.2f}s/step)", flush=True)
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, (params, opt_state),
                                {"step": step + 1})
    ckpt.wait()
    ckpt.save(args.steps, (params, opt_state), {"step": args.steps})
    pipe.close()
    client.close()
    release_local_mesh(mesh)
    s = engine.snapshot()
    dt = time.time() - t_start
    if losses:
        print(f"[train] done: {args.steps - start_step} steps in {dt:.1f}s; "
              f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
              f"cache CHR {s['hit_ratio']:.3f}, "
              f"prefetch_hits {s['prefetch_hits']}")
    else:
        print(f"[train] done: nothing to run from step {start_step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
