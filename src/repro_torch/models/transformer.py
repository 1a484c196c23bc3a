"""The model: specs, forward and decode — dense family (torch).

Counterpart of ``repro.models.transformer`` for the dense family: a Python
loop over the stacked ``(L, ...)`` layer params takes the place of
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

PORTED_FAMILIES = ("dense",)
_SLICE_OF = {
    "moe": "MoE",
    "ssm": "SSM/hybrid (with ssd_chunk_pallas)",
    "hybrid": "SSM/hybrid (with ssd_chunk_pallas)",
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
    specs["blocks"] = {**attention_specs(cfg, L), **mlp_specs(cfg, L)}
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
        out, _ = attention(x, lp, cfg, positions=positions,
                           force_ref=force_ref)
        x = x + out
        x = x + swiglu(x, lp, cfg, force_ref=force_ref)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    return x @ _head(params, cfg), aux


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda") -> Dict[str, Any]:
    """Decode cache (zeros; k/v in bf16 whatever the params' type).  ``pos``
    is a Python int shared by the whole batch, as the JAX scalar is."""
    _require_ported(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = (L, batch, max_seq, KV, hd)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
            "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}


def decode_step(params, cfg: ModelConfig, state, tokens, *,
                force_ref: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence in the batch.  tokens: (B, 1).

    The KV caches in ``state`` are updated in place (the JAX version returns
    new arrays; copying a cache per step would double its traffic); the
    returned state is a new dict holding the same cache tensors and
    ``pos + 1``."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    pos = int(state["pos"])
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        lp = _layer(blocks, i)
        out, _ = attention(x, lp, cfg, positions=positions,
                           cache=(state["k"][i], state["v"][i]),
                           cache_len=pos, force_ref=force_ref)
        x = x + out
        x = x + swiglu(x, lp, cfg, force_ref=force_ref)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    return x @ _head(params, cfg), dict(state, pos=pos + 1)
