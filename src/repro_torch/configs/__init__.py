"""Assigned-architecture registry: ``--arch <id>`` resolves here (the port's
own copy of ``repro.configs``, kept identical to it)."""
from __future__ import annotations

from dataclasses import replace

from ..models.config import ModelConfig, SHAPES, ShapeSpec
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .llama_3_2_vision_90b import CONFIG as llama_3_2_vision_90b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .llama3_405b import CONFIG as llama3_405b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .qwen3_1_7b import CONFIG as qwen3_1_7b
from .zamba2_1_2b import CONFIG as zamba2_1_2b
from .musicgen_large import CONFIG as musicgen_large
from .mamba2_370m import CONFIG as mamba2_370m

CONFIGS = {
    c.name: c for c in [
        qwen3_moe_30b_a3b, granite_moe_3b_a800m, llama_3_2_vision_90b,
        qwen2_5_14b, llama3_405b, mistral_large_123b, qwen3_1_7b,
        zamba2_1_2b, musicgen_large, mamba2_370m,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(CONFIGS)}")
    return CONFIGS[name]


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    c = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, vocab=256,
        n_heads=4 if c.n_heads else 0,
        n_kv_heads=min(c.n_kv_heads, 2) if c.n_heads else 0,
        head_dim=16 if c.n_heads else 0,
        d_ff=128 if c.d_ff else 0,
        rope_theta=10000.0,
    )
    if c.family == "moe":
        kw.update(n_experts=4, top_k=2, d_ff=64)
    if c.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
    if c.family == "hybrid":
        kw.update(shared_attn_every=2)
    if c.family == "vlm":
        kw.update(cross_attn_every=2, n_image_tokens=16)
    if c.family == "audio":
        kw.update(n_codebooks=c.n_codebooks)
    return replace(c, **kw)


__all__ = ["CONFIGS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "reduced_config"]
