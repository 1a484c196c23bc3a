"""The model: specs, forward and decode — dense, ssm and hybrid families
(torch).

Counterpart of ``repro.models.transformer`` for those families:

  dense  : attention + SwiGLU per layer
  ssm    : Mamba2 SSD block per layer
  hybrid : Mamba2 block per layer + one weight-SHARED attention/MLP block
           fired every ``shared_attn_every`` layers (the Zamba2 design)

A Python loop over the stacked ``(L, ...)`` layer params takes the place of
``lax.scan``; ``remat`` is accepted and ignored (serving keeps no
activations).  The other families raise ``NotImplementedError`` naming the
ROADMAP slice that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..kernels import rmsnorm
from .config import ModelConfig
from .layers import attention, attention_specs, mlp_specs, swiglu
from .params import p, tree_abstract, tree_init
from .ssm import init_ssm_state, mamba_block, ssm_specs

PORTED_FAMILIES = ("dense", "ssm", "hybrid")
_SLICE_OF = {
    "moe": "MoE",
    "vlm": "VLM and audio",
    "audio": "VLM and audio",
}


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it comes "
            f"with the {_SLICE_OF.get(cfg.family, cfg.family)!r} slice of "
            "ROADMAP.md")


# ------------------------------------------------------------------ specs

def build_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_ported(cfg)
    d, L = cfg.d_model, cfg.n_layers
    specs: Dict[str, Any] = {
        "embed": p((cfg.vocab, d), ("embed_vocab", "embed"), scale=1.0),
        "final_norm": p((d,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = p((d, cfg.vocab), ("embed", "vocab"))
    if cfg.family == "dense":
        specs["blocks"] = {**attention_specs(cfg, L), **mlp_specs(cfg, L)}
    else:
        specs["blocks"] = ssm_specs(cfg, L)
    if cfg.family == "hybrid":
        shared = {**attention_specs(cfg, 1), **mlp_specs(cfg, 1)}
        specs["shared"] = {k: p(v.shape[1:], v.axes[1:], v.init, v.scale)
                           for k, v in shared.items()}
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters on ``device`` (default: the generator's device);
    a full-width model is initialised on the card with a CUDA generator."""
    return tree_init(build_specs(cfg), generator, device)


def abstract_params(cfg: ModelConfig):
    return tree_abstract(build_specs(cfg))


def _layer(blocks, i: int):
    return {k: v[i] for k, v in blocks.items()}


def _head(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _fires_shared(cfg: ModelConfig, i: int) -> bool:
    return cfg.family == "hybrid" and i % cfg.shared_attn_every == 0


def _shared_block(x, sp, cfg: ModelConfig, positions, cache=None,
                  cache_len=None, force_ref: bool = False):
    """Zamba2 weight-shared attention+MLP block (params have no layer dim)."""
    out, new_cache = attention(x, sp, cfg, positions=positions, cache=cache,
                               cache_len=cache_len, force_ref=force_ref)
    x = x + out
    x = x + swiglu(x, sp, cfg, force_ref=force_ref)
    return x, new_cache


# ------------------------------------------------------------------ forward

def forward(params, cfg: ModelConfig, tokens, *, remat: str = "full",
            force_ref: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (prefill).  Returns (logits, aux_loss)."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        if cfg.family == "dense":
            out, _ = attention(x, lp, cfg, positions=positions,
                               force_ref=force_ref)
            x = x + out
            x = x + swiglu(x, lp, cfg, force_ref=force_ref)
        else:
            x, _ = mamba_block(x, lp, cfg, force_ref=force_ref)
        if _fires_shared(cfg, i):
            x, _ = _shared_block(x, params["shared"], cfg, positions,
                                 force_ref=force_ref)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    return x @ _head(params, cfg), aux


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> Dict[str, Any]:
    """Decode cache (zeros).  dense: k/v (L, B, max_seq, KV, hd) in bf16
    whatever the params' type; ssm/hybrid: conv (L, B, W-1, conv_ch) in
    bf16 and ssd (L, B, nh, p, n) in f32; hybrid also shared_k/v
    (n_inv, B, max_seq, KV, hd) in bf16, n_inv = ceil(L / every).  ``pos``
    is a Python int shared by the whole batch, as the JAX scalar is."""
    _require_ported(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    state: Dict[str, Any] = {"pos": 0}

    def kv(n):
        return torch.zeros((n, batch, max_seq, KV, hd), dtype=torch.bfloat16,
                           device=device)
    if cfg.family == "dense":
        state["k"], state["v"] = kv(L), kv(L)
        return state
    conv, ssd_st = init_ssm_state(cfg, batch, device=device)
    state["conv"] = conv[None].repeat(L, 1, 1, 1)
    state["ssd"] = ssd_st[None].repeat(L, 1, 1, 1, 1)
    if cfg.family == "hybrid":
        n_inv = -(-L // cfg.shared_attn_every)
        state["shared_k"], state["shared_v"] = kv(n_inv), kv(n_inv)
    return state


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                force_ref: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence in the batch.  tokens: (B, 1).

    The stacked caches in ``state`` (k/v; conv, ssd and shared_k/v) are
    updated in place (the JAX version returns new arrays; copying a cache
    per step would double its traffic); the returned state is a new dict
    holding the same cache tensors and ``pos + 1``.  One exception, as in
    JAX, where the scan's output takes the activations' type: a conv state
    of another dtype than the activations (bf16 zeros under f32 weights) is
    replaced by a converted copy on the first step."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    pos = int(state["pos"])
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    blocks = params["blocks"]
    new_state = dict(state, pos=pos + 1)
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            lp = _layer(blocks, i)
            out, _ = attention(x, lp, cfg, positions=positions,
                               cache=(state["k"][i], state["v"][i]),
                               cache_len=pos, force_ref=force_ref)
            x = x + out
            x = x + swiglu(x, lp, cfg, force_ref=force_ref)
    else:
        conv, ssd_st = state["conv"], state["ssd"]
        if conv.dtype != x.dtype:
            conv = new_state["conv"] = conv.to(x.dtype)
        for i in range(cfg.n_layers):
            x, (c, s) = mamba_block(x, _layer(blocks, i), cfg,
                                    state=(conv[i], ssd_st[i]),
                                    force_ref=force_ref)
            conv[i].copy_(c)
            ssd_st[i].copy_(s)
            if _fires_shared(cfg, i):
                inv = i // cfg.shared_attn_every
                x, _ = _shared_block(
                    x, params["shared"], cfg, positions,
                    cache=(state["shared_k"][inv], state["shared_v"][inv]),
                    cache_len=pos, force_ref=force_ref)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    return x @ _head(params, cfg), new_state
