"""Serving steps: prefill (full-sequence forward) and decode (one token with
a KV cache), under ``torch.inference_mode``, and the decode state's shapes
and shardings.

Counterpart of ``repro.serve.serve_step``.  ``make_prefill`` and
``make_serve_step`` take ``(mesh, rules)`` as the reference does and run
inside ``sharding_ctx`` on the mesh's device; a device in the mesh's place
builds the unmeshed step on that device.  Rules without a mesh raise
(``sharding.context.step_target``).  On a ``DeviceMesh`` of more than one
rank (any family) the params are DTensors placed by the rules
(``sharding.distribute_tree``); each rank passes the same global tokens
and decode state, and the step distributes them
(``sharding.distribute_inputs``, ``decode_state_shardings``; a state's
DTensor leaves stay as they are, so the returned state is updated in place
from the first step on).  The dry-run's steps (``trace=True``) take any
mesh and run on ``meta`` tensors only.  ``lower_prefill`` and
``lower_serve_step`` return
those steps with their abstract inputs (``roofline.trace.Lowered``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import is_dtensor
from ..models.config import ModelConfig, ShapeSpec
from ..models.transformer import (abstract_params, build_specs, decode_step,
                                  forward, init_decode_state)
from ..roofline.trace import Lowered
from ..sharding import (CACHE_AXES, LogicalRules, distribute_inputs,
                        distribute_tree, logical_sharding, sharding_ctx,
                        shardings_for)
from ..sharding.context import (multi_rank, require_distributed,
                                step_target, traced_input, traced_inputs)


def decode_state_structs(cfg: ModelConfig, shape: ShapeSpec
                         ) -> Dict[str, Any]:
    """The decode state of ``shape``'s batch and KV length as ``meta``
    tensors (shapes and dtypes; ``pos`` a 0-d int32)."""
    state = init_decode_state(cfg, 1, 8, device="meta")  # tiny template
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    def fix(name, leaf):
        if name == "pos":
            return meta((), torch.int32)
        if name in ("k", "v", "shared_k", "shared_v"):
            return meta((leaf.shape[0], B, S, cfg.n_kv_heads, cfg.hd),
                        torch.bfloat16)
        if name in ("conv", "img_kv"):
            return meta((leaf.shape[0], B) + tuple(leaf.shape[2:]),
                        torch.bfloat16)
        if name == "ssd":
            return meta((leaf.shape[0], B) + tuple(leaf.shape[2:]),
                        torch.float32)
        raise KeyError(name)

    return {k: (tuple(fix(k, leaf) for leaf in v) if k == "img_kv"
                else fix(k, v)) for k, v in state.items()}


def decode_state_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                           rules: Optional[LogicalRules] = None):
    structs = decode_state_structs(cfg, shape)
    return {k: (tuple(logical_sharding(CACHE_AXES[k], leaf.shape, mesh, rules)
                      for leaf in v) if k == "img_kv"
                else logical_sharding(CACHE_AXES[k], v.shape, mesh, rules))
            for k, v in structs.items()}


def _placer(dev, trace: bool, mesh=None, rules=None):
    """The step's input placer, ``place(**inputs) -> inputs``: each to the
    device (and, across ranks, placed by ``distribute_inputs``; a DTensor
    is redistributed where it lies), ``None`` kept; or (a traced step)
    each checked to be ``meta`` and passed as it is."""
    def place(**inputs):
        if trace:
            return {k: traced_input(v) for k, v in inputs.items()}
        out = {k: v if is_dtensor(v) else torch.as_tensor(v, device=dev)
               for k, v in inputs.items() if v is not None}
        if mesh is not None:
            out = distribute_inputs(out, mesh, rules)
        return {k: out.get(k) for k in inputs}
    return place


def _grad_off(across: bool):
    """``torch.inference_mode()``; across ranks ``torch.no_grad()``:
    DTensor's view ops (``unbind`` of the stacked layers) cannot set an
    inference tensor's version counter."""
    return torch.no_grad() if across else torch.inference_mode()


def distribute_state(cfg: ModelConfig, state, mesh,
                     rules: Optional[LogicalRules] = None):
    """A decode state (``init_decode_state``'s) placed as
    ``decode_state_shardings`` places one of its shapes, each leaf by its
    ``CACHE_AXES`` at its own shape (``pos``, a Python int, as a 0-d
    leaf); DTensor leaves are redistributed, so a placed state passes
    unchanged.  No tensor is made for the shapes: a rank's step runs this,
    and the dry-run counts what that step allocates."""
    def sharding(name, leaf):
        return logical_sharding(CACHE_AXES[name], getattr(leaf, "shape", ()),
                                mesh, rules)
    return distribute_tree(state, {
        k: (tuple(sharding(k, leaf) for leaf in v) if k == "img_kv"
            else sharding(k, v)) for k, v in state.items()})


def make_serve_step(cfg: ModelConfig, mesh="cuda",
                    rules: Optional[LogicalRules] = None, *,
                    force_ref: bool = False, trace: bool = False):
    """``serve_step(params, state, tokens=None, inputs_embeds=None) ->
    (logits, state)``; tokens (B, 1) or inputs_embeds (B, 1, d), as arrays
    or tensors, moved to the device.  ``trace`` builds the dry-run's step
    (``lower_serve_step``): ``meta`` tensors only, on any mesh."""
    mesh, dev = step_target(mesh, rules, trace)
    across = multi_rank(mesh) and not trace
    place = _placer(dev, trace, mesh if across else None, rules)

    def serve_step(params, state, tokens=None, inputs_embeds=None):
        if trace:
            traced_inputs((params, state))
        elif across:
            require_distributed(params)
            state = distribute_state(cfg, state, mesh, rules)
        x = place(tokens=tokens, inputs_embeds=inputs_embeds)
        with _grad_off(across), sharding_ctx(mesh, rules):
            return decode_step(params, cfg, state, x["tokens"],
                               inputs_embeds=x["inputs_embeds"],
                               force_ref=force_ref)
    return serve_step


def make_prefill(cfg: ModelConfig, mesh="cuda",
                 rules: Optional[LogicalRules] = None, *,
                 force_ref: bool = False, trace: bool = False):
    """``prefill(params, tokens=None, inputs_embeds=None, img_embeds=None)
    -> logits``; tokens (B, S) or inputs_embeds (B, S, d), and a vlm's
    img_embeds (B, n_image_tokens, d).  ``trace`` as in
    ``make_serve_step``."""
    mesh, dev = step_target(mesh, rules, trace)
    across = multi_rank(mesh) and not trace
    place = _placer(dev, trace, mesh if across else None, rules)

    def prefill(params, tokens=None, inputs_embeds=None, img_embeds=None):
        if trace:
            traced_inputs(params)
        elif across:
            require_distributed(params)
        x = place(tokens=tokens, inputs_embeds=inputs_embeds,
                  img_embeds=img_embeds)
        with _grad_off(across), sharding_ctx(mesh, rules):
            logits, _ = forward(params, cfg, x["tokens"],
                                inputs_embeds=x["inputs_embeds"],
                                img_embeds=x["img_embeds"],
                                remat="none", force_ref=force_ref)
        return logits
    return prefill


def lower_serve_step(cfg: ModelConfig, shape: ShapeSpec, mesh,
                     rules: Optional[LogicalRules] = None,
                     unroll: int = 1) -> Lowered:
    """One decode step at (batch, kv_len = shape.seq_len) on abstract
    inputs, the state donated; audio on a frame embedding (B, 1, d).  The
    traced step writes position ``seq_len - 1`` (the cost of a step does
    not depend on it).  ``unroll`` is accepted for the reference's
    signature."""
    specs = build_specs(cfg)
    params_s = abstract_params(cfg)
    params_sh = shardings_for(specs, mesh, rules)
    state_s = decode_state_structs(cfg, shape)
    state_sh = decode_state_shardings(cfg, shape, mesh, rules)
    B = shape.global_batch
    key = "inputs_embeds" if cfg.family == "audio" else "tokens"
    if key == "inputs_embeds":
        x_s = torch.empty((B, 1, cfg.d_model), dtype=torch.bfloat16,
                          device="meta")
        names = ("batch", "seq", "act_embed")
    else:
        x_s = torch.empty((B, 1), dtype=torch.int32, device="meta")
        names = ("batch", "seq")

    def build(m, trace: bool):
        step = make_serve_step(cfg, m, rules, trace=trace)

        def positional(params, state, x):
            return step(params, dict(state, pos=shape.seq_len - 1),
                        **{key: x})
        return positional
    logits_sh = logical_sharding(("batch", "seq", "act_vocab"),
                                 (B, 1, cfg.vocab), mesh, rules)
    return Lowered(build, (params_s, state_s, x_s),
                   (params_sh, state_sh,
                    logical_sharding(names, x_s.shape, mesh, rules)),
                   out_shardings=(logits_sh, state_sh), donate_argnums=(1,),
                   mesh=mesh, rules=rules, kind="decode")


def lower_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules: Optional[LogicalRules] = None,
                  unroll: int = 1) -> Lowered:
    """The prefill (a full-sequence forward) on abstract inputs: tokens
    (B, S), or audio's ``inputs_embeds`` (B, S, d), and a vlm's
    ``img_embeds`` (B, n_image_tokens, d).  ``unroll`` is accepted for the
    reference's signature."""
    specs = build_specs(cfg)
    params_s = abstract_params(cfg)
    params_sh = shardings_for(specs, mesh, rules)
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")
    kwargs_s = {}
    if cfg.family == "audio":
        kwargs_s["inputs_embeds"] = meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        kwargs_s["tokens"] = meta((B, S), torch.int32)
    if cfg.family == "vlm":
        kwargs_s["img_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_model),
                                      torch.bfloat16)
    names = {"tokens": ("batch", "seq"),
             "inputs_embeds": ("batch", "seq", "act_embed"),
             "img_embeds": ("batch", "seq", "act_embed")}
    keys = sorted(kwargs_s)
    args_sh = tuple(logical_sharding(names[k], kwargs_s[k].shape, mesh, rules)
                    for k in keys)

    def build(m, trace: bool):
        fn = make_prefill(cfg, m, rules, trace=trace)

        def positional(p, *vals):
            return fn(p, **dict(zip(keys, vals)))
        return positional
    logits_sh = logical_sharding(("batch", "seq", "act_vocab"),
                                 (B, S, cfg.vocab), mesh, rules)
    return Lowered(build, (params_s,) + tuple(kwargs_s[k] for k in keys),
                   (params_sh,) + args_sh, out_shardings=logits_sh,
                   mesh=mesh, rules=rules, kind="prefill")
