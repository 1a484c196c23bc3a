"""Serving steps: prefill (full-sequence forward) and decode (one token with
a KV cache), under ``torch.inference_mode``, and the decode state's shapes
and shardings.

Counterpart of ``repro.serve.serve_step``.  ``make_prefill`` and
``make_serve_step`` take ``(mesh, rules)`` as the reference does and run
inside ``sharding_ctx`` on the mesh's device; a device in the mesh's place
builds the unmeshed step on that device.  Rules without a mesh, and a mesh
of more than one device, raise (``sharding.context.step_target``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.config import ModelConfig, ShapeSpec
from ..models.transformer import decode_step, forward, init_decode_state
from ..sharding import LogicalRules, logical_sharding, sharding_ctx
from ..sharding.context import step_target

CACHE_AXES = {
    "pos": (),
    "k": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
    "v": ("layers", "cache_batch", "cache_seq", "kv_heads", None),
    "conv": ("layers", "cache_batch", None, "ssm_inner"),
    "ssd": ("layers", "cache_batch", "ssm_heads", None, None),
    "shared_k": (None, "cache_batch", "cache_seq", "kv_heads", None),
    "shared_v": (None, "cache_batch", "cache_seq", "kv_heads", None),
    "img_kv": (None, "cache_batch", None, "kv_heads", None),
}


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


def _on(t, dev):
    return None if t is None else torch.as_tensor(t, device=dev)


def make_serve_step(cfg: ModelConfig, mesh="cuda",
                    rules: Optional[LogicalRules] = None, *,
                    force_ref: bool = False):
    """``serve_step(params, state, tokens=None, inputs_embeds=None) ->
    (logits, state)``; tokens (B, 1) or inputs_embeds (B, 1, d), as arrays
    or tensors, moved to the device."""
    mesh, dev = step_target(mesh, rules)

    def serve_step(params, state, tokens=None, inputs_embeds=None):
        with torch.inference_mode(), sharding_ctx(mesh, rules):
            return decode_step(params, cfg, state, _on(tokens, dev),
                               inputs_embeds=_on(inputs_embeds, dev),
                               force_ref=force_ref)
    return serve_step


def make_prefill(cfg: ModelConfig, mesh="cuda",
                 rules: Optional[LogicalRules] = None, *,
                 force_ref: bool = False):
    """``prefill(params, tokens=None, inputs_embeds=None, img_embeds=None)
    -> logits``; tokens (B, S) or inputs_embeds (B, S, d), and a vlm's
    img_embeds (B, n_image_tokens, d)."""
    mesh, dev = step_target(mesh, rules)

    def prefill(params, tokens=None, inputs_embeds=None, img_embeds=None):
        with torch.inference_mode(), sharding_ctx(mesh, rules):
            logits, _ = forward(params, cfg, _on(tokens, dev),
                                inputs_embeds=_on(inputs_embeds, dev),
                                img_embeds=_on(img_embeds, dev),
                                remat="none", force_ref=force_ref)
        return logits
    return prefill
