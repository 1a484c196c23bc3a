"""Train step: loss -> grad -> AdamW, with microbatch gradient accumulation
and per-layer remat (torch).

Counterpart of ``repro.train.train_step``.  PyTorch runs eagerly, so the
returned step is a plain function.  Given a ``mesh`` (and ``rules``), the
step runs inside ``sharding_ctx`` with the batch on the mesh's device; on a
one-device mesh the params and moments stay plain tensors and every result
equals the unmeshed step's; rules without a mesh raise
(``sharding.context.step_target``).  On a ``DeviceMesh`` of more than one
rank (any family) the params and moments are DTensors placed by the
rules (``sharding.distribute_tree`` of ``shardings_for``, ``init_state``),
every rank passes the same global batch and the step distributes it
(``sharding.distribute_inputs``, as ``batch_shardings`` places it); each
grad is brought to its param's placements before AdamW (the data axis's
reduction).  Grads come from
``torch.autograd.grad`` on detached views of the params (nothing lands in
``.grad``); a param the loss does not reach (audio's ``embed`` under
``inputs_embeds``) gets zeros, as ``jax.value_and_grad`` gives it.  With
``microbatches > 1`` each microbatch's grads are added as
``g.float() / microbatches`` into f32 buffers, as the JAX scan does; with one
microbatch the optimizer receives grads in the params' dtype.
``lower_train_step`` is the dry-run's entry: the step built with
``trace=True`` (any mesh, ``meta`` tensors only) and its abstract inputs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import is_dtensor
from ..models.config import ModelConfig, ShapeSpec
from ..models.params import tree_leaves, tree_unflatten
from ..models.transformer import (abstract_params, build_specs, forward,
                                  lm_loss, lm_loss_chunked)
from ..roofline.trace import Lowered
from ..sharding import (INPUT_AXES, LogicalRules, distribute_inputs,
                        logical_sharding, sharding_ctx, shardings_for)
from ..sharding.context import (multi_rank, require_distributed,
                                step_target, traced_inputs)
from ..sharding.rules import NamedSharding, P
from .optimizer import (AdamWConfig, AdamWState, abstract_state,
                        apply_updates, tree_map)

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


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    rules: Optional[LogicalRules] = None):
    structs = batch_structs(cfg, shape)
    return {k: logical_sharding(INPUT_AXES[k], v.shape, mesh, rules)
            for k, v in structs.items()}



def make_value_and_grad(cfg: ModelConfig, *, remat: str = "full",
                        loss_impl: str = "dense", force_ref: bool = False):
    """``value_and_grad(params, batch) -> (loss, grads)``: the loss of one
    batch and its grads (a tree like ``params``, in the params' dtypes),
    from ``torch.autograd.grad`` on detached views of the params.  The
    batch holds ``labels`` and ``tokens`` or ``inputs_embeds``, and a vlm's
    ``img_embeds`` where given.  ``force_ref`` runs the kernels' plain
    versions (on-card comparisons)."""
    if loss_impl not in LOSS_IMPLS:
        raise ValueError(f"loss_impl {loss_impl!r} not in {LOSS_IMPLS}")

    def loss_fn(params, batch):
        out, aux = forward(params, cfg, batch.get("tokens"),
                           inputs_embeds=batch.get("inputs_embeds"),
                           img_embeds=batch.get("img_embeds"), remat=remat,
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
            grads = torch.autograd.grad(loss, req, allow_unused=True)
        grads = [torch.zeros_like(r) if g is None else g
                 for g, r in zip(grads, req)]
        grads = [g.redistribute(r.device_mesh, r.placements)
                 if is_dtensor(g) else g for g, r in zip(grads, req)]
        return loss.detach(), tree_unflatten(zip(paths, grads))
    return value_and_grad


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh=None,
                    rules=None, *, remat: str = "full", microbatches: int = 1,
                    unroll: int = 1, loss_impl: str = "dense",
                    trace: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` (``batch_structs``' keys) lies on the params'
    device (with a mesh: is moved to the mesh's), and microbatching splits
    each of its tensors.  Params and moments are updated in place.
    ``unroll`` is accepted for the reference's signature (a Python loop has
    nothing to unroll).  ``trace`` builds the dry-run's step
    (``lower_train_step``): ``meta`` tensors only, on any mesh."""
    dev = None
    if mesh is not None or rules is not None or trace:
        mesh, dev = step_target(mesh, rules, trace)
    across = multi_rank(mesh) and not trace
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    value_and_grad = make_value_and_grad(cfg, remat=remat,
                                         loss_impl=loss_impl)

    def step(params, opt_state: AdamWState, batch):
        if microbatches > 1:
            g_acc = tree_map(lambda a: torch.zeros_like(
                a, dtype=torch.float32,
                memory_format=torch.contiguous_format), params)
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

    def train_step(params, opt_state: AdamWState, batch):
        if trace:
            traced_inputs((params, opt_state, batch))
        elif across:
            require_distributed(params)
            batch = distribute_inputs(batch, mesh, rules)
        elif dev is not None:
            batch = {k: v.to(dev) for k, v in batch.items()}
        with sharding_ctx(mesh, rules):
            return step(params, opt_state, batch)

    return train_step


def lower_train_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     rules: Optional[LogicalRules] = None, *,
                     remat: str = "full", microbatches: int = 1,
                     opt_cfg: Optional[AdamWConfig] = None, unroll: int = 1,
                     loss_impl: str = "dense") -> Lowered:
    """The train step on abstract inputs (the dry-run entry): params,
    AdamW state and one global batch as ``meta`` tensors with their
    shardings on ``mesh``, params and state donated, as the reference's
    ``jax.jit(...).lower``; ``.compile()`` traces it
    (``roofline.trace``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    specs = build_specs(cfg)
    params_s = abstract_params(cfg)
    params_sh = shardings_for(specs, mesh, rules)
    opt_s = abstract_state(params_s)
    opt_sh = AdamWState(NamedSharding(mesh, P()), params_sh, params_sh)
    def build(m, trace: bool):
        return make_train_step(cfg, opt_cfg, m, rules, remat=remat,
                               microbatches=microbatches, unroll=unroll,
                               loss_impl=loss_impl, trace=trace)
    return Lowered(build, (params_s, opt_s, batch_structs(cfg, shape)),
                   (params_sh, opt_sh,
                    batch_shardings(cfg, shape, mesh, rules)),
                   out_shardings=(params_sh, opt_sh, None),
                   donate_argnums=(0, 1), mesh=mesh, rules=rules,
                   kind="train")
