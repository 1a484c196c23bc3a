"""Serving steps: prefill (full-sequence forward) and decode (one token with
a KV cache), on one device under ``torch.inference_mode``.

Counterpart of ``repro.serve.serve_step``'s ``make_serve_step`` and
``make_prefill``; the mesh and sharding-struct helpers come with the sharding
slice.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import decode_step, forward


def _on(t, dev):
    return None if t is None else torch.as_tensor(t, device=dev)


def make_serve_step(cfg: ModelConfig, device="cuda", *,
                    force_ref: bool = False):
    """``serve_step(params, state, tokens=None, inputs_embeds=None) ->
    (logits, state)``; tokens (B, 1) or inputs_embeds (B, 1, d), as arrays
    or tensors, moved to ``device``."""
    dev = resolve_device(device)

    def serve_step(params, state, tokens=None, inputs_embeds=None):
        with torch.inference_mode():
            return decode_step(params, cfg, state, _on(tokens, dev),
                               inputs_embeds=_on(inputs_embeds, dev),
                               force_ref=force_ref)
    return serve_step


def make_prefill(cfg: ModelConfig, device="cuda", *, force_ref: bool = False):
    """``prefill(params, tokens=None, inputs_embeds=None, img_embeds=None)
    -> logits``; tokens (B, S) or inputs_embeds (B, S, d), and a vlm's
    img_embeds (B, n_image_tokens, d)."""
    dev = resolve_device(device)

    def prefill(params, tokens=None, inputs_embeds=None, img_embeds=None):
        with torch.inference_mode():
            logits, _ = forward(params, cfg, _on(tokens, dev),
                                inputs_embeds=_on(inputs_embeds, dev),
                                img_embeds=_on(img_embeds, dev),
                                remat="none", force_ref=force_ref)
        return logits
    return prefill
