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


def make_serve_step(cfg: ModelConfig, device="cuda", *,
                    force_ref: bool = False):
    """``serve_step(params, state, tokens) -> (logits, state)``; tokens (B, 1)
    as an array or tensor, moved to ``device``."""
    dev = resolve_device(device)

    def serve_step(params, state, tokens):
        with torch.inference_mode():
            return decode_step(params, cfg, state,
                               torch.as_tensor(tokens, device=dev),
                               force_ref=force_ref)
    return serve_step


def make_prefill(cfg: ModelConfig, device="cuda", *, force_ref: bool = False):
    """``prefill(params, tokens) -> logits``; tokens (B, S)."""
    dev = resolve_device(device)

    def prefill(params, tokens):
        with torch.inference_mode():
            logits, _ = forward(params, cfg, torch.as_tensor(tokens, device=dev),
                                remat="none", force_ref=force_ref)
        return logits
    return prefill
