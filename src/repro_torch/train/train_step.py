"""Train step: loss -> grad -> AdamW, with microbatch gradient accumulation
and per-layer remat (torch).

Counterpart of ``repro.train.train_step``.  PyTorch runs eagerly, so the
returned step is a plain function; ``mesh`` and ``rules`` are accepted only
as ``None`` until the sharding slice.  Grads come from
``torch.autograd.grad`` on detached views of the params (nothing lands in
``.grad``).  With ``microbatches > 1`` each microbatch's grads are added as
``g.float() / microbatches`` into f32 buffers, as the JAX scan does; with one
microbatch the optimizer receives grads in the params' dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.config import ModelConfig, ShapeSpec
from ..models.params import tree_leaves, tree_unflatten
from ..models.transformer import (forward, lm_loss, lm_loss_chunked,
                                  require_trainable)
from .optimizer import AdamWConfig, AdamWState, apply_updates, tree_map

LOSS_IMPLS = ("dense", "chunked")


def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shapes and dtypes of one global training batch, on ``meta``."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"labels": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.family == "audio":
        # frontend stub: precomputed EnCodec frame embeddings
        batch["inputs_embeds"] = torch.empty((B, S, cfg.d_model),
                                             dtype=torch.bfloat16,
                                             device="meta")
    else:
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32,
                                      device="meta")
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.empty((B, cfg.n_image_tokens,
                                           cfg.d_model),
                                          dtype=torch.bfloat16, device="meta")
    return batch


def make_value_and_grad(cfg: ModelConfig, *, remat: str = "full",
                        loss_impl: str = "dense", force_ref: bool = False):
    """``value_and_grad(params, batch) -> (loss, grads)``: the loss of one
    batch and its grads (a tree like ``params``, in the params' dtypes),
    from ``torch.autograd.grad`` on detached views of the params.
    ``force_ref`` runs the kernels' plain versions (on-card comparisons)."""
    require_trainable(cfg)
    if loss_impl not in LOSS_IMPLS:
        raise ValueError(f"loss_impl {loss_impl!r} not in {LOSS_IMPLS}")

    def loss_fn(params, batch):
        out, aux = forward(params, cfg, batch["tokens"], remat=remat,
                           force_ref=force_ref,
                           return_hidden=(loss_impl == "chunked"))
        maux = aux if cfg.family == "moe" else None
        if loss_impl == "chunked":
            return lm_loss_chunked(out, params, cfg, batch["labels"], maux)
        return lm_loss(out, batch["labels"], maux)

    def value_and_grad(params, batch):
        paths, leaves = zip(*tree_leaves(params))
        req = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(zip(paths, req)), batch)
            grads = torch.autograd.grad(loss, req)
        return loss.detach(), tree_unflatten(zip(paths, grads))
    return value_and_grad


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    rules=None, *, remat: str = "full", microbatches: int = 1,
                    unroll: int = 1, loss_impl: str = "dense"):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens`` and ``labels`` on the params'
    device.  Params and moments are updated in place.  ``unroll`` is
    accepted for the reference's signature (a Python loop has nothing to
    unroll)."""
    if mesh is not None or rules is not None:
        raise NotImplementedError(
            "mesh / rules: sharding is not ported yet; it comes with "
            "ROADMAP.md Queue 1 item 4")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    value_and_grad = make_value_and_grad(cfg, remat=remat,
                                         loss_impl=loss_impl)

    def train_step(params, opt_state: AdamWState, batch):
        if microbatches > 1:
            g_acc = tree_map(lambda a: torch.zeros(a.shape,
                                                   dtype=torch.float32,
                                                   device=a.device), params)
            losses = []
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                loss_i, g = value_and_grad(params, mb)
                tree_map(lambda acc, gi: acc.add_(gi.float() / microbatches),
                         g_acc, g)
                losses.append(loss_i)
                del g
            grads, loss = g_acc, torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(params, batch)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step
