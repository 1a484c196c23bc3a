"""The model: specs, forward and decode — dense, ssm and hybrid families
(torch).

Counterpart of ``repro.models.transformer`` for those families:

  dense  : attention + SwiGLU per layer
  ssm    : Mamba2 SSD block per layer
  hybrid : Mamba2 block per layer + one weight-SHARED attention/MLP block
           fired every ``shared_attn_every`` layers (the Zamba2 design)

A Python loop over the stacked ``(L, ...)`` layer params takes the place of
``lax.scan``, each leaf unbound once per call (``torch.unbind``: its
backward stacks the layers' grads once, where indexing ``v[i]`` would
allocate a zero tensor the size of the whole stack for every layer).
``remat`` maps ``jax.checkpoint`` per layer to ``torch.utils.checkpoint``
(non-reentrant): ``"full"`` recomputes the layer, ``"dots"`` saves its
``aten.mm`` outputs (``dots_with_no_batch_dims_saveable``), ``"none"``
checkpoints nothing; the final norm and the head stay outside, as in JAX.
``lm_loss`` and ``lm_loss_chunked`` are the training losses.  Training is
ported for the dense family; the other families raise
``NotImplementedError`` naming the ROADMAP slice that ports them.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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


TRAINED_FAMILIES = ("dense",)
REMAT_POLICIES = ("none", "full", "dots")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it comes "
            f"with the {_SLICE_OF.get(cfg.family, cfg.family)!r} slice of "
            "ROADMAP.md")


def require_trainable(cfg: ModelConfig) -> None:
    """Training is ported for the dense family only: the SSD chunk kernel
    has no backward yet."""
    _require_ported(cfg)
    if cfg.family not in TRAINED_FAMILIES:
        raise NotImplementedError(
            f"training {cfg.family!r} models ({cfg.name}) is not ported yet: "
            "it comes with the 'ssm/hybrid training' slice of ROADMAP.md, "
            "which brings an SSD chunk backward kernel")


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


def _layers(blocks) -> List[Dict[str, torch.Tensor]]:
    """One dict of views per layer, from one ``unbind`` of each stacked
    ``(L, ...)`` leaf."""
    keys = sorted(blocks)
    return [dict(zip(keys, vals))
            for vals in zip(*(torch.unbind(blocks[k]) for k in keys))]


def _save_mm(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep matrix products (``aten.mm``, what ``@`` of a
    (B, S, d) activation by a weight lowers to), recompute the rest."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the per-layer checkpoint that ``remat`` names."""
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_mm))
    raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")


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
            force_ref: bool = False,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / prefill).  Returns (logits, aux_loss),
    or (final-normed hidden states, aux_loss) with ``return_hidden``."""
    _require_ported(cfg)
    x = params["embed"][tokens]
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp, i):
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
        return x

    layer = _remat(body, remat)
    for i, lp in enumerate(_layers(params["blocks"])):
        x = layer(x, lp, i)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    if return_hidden:
        return x, aux
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
        for i, lp in enumerate(_layers(blocks)):
            out, _ = attention(x, lp, cfg, positions=positions,
                               cache=(state["k"][i], state["v"][i]),
                               cache_len=pos, force_ref=force_ref)
            x = x + out
            x = x + swiglu(x, lp, cfg, force_ref=force_ref)
    else:
        conv, ssd_st = state["conv"], state["ssd"]
        if conv.dtype != x.dtype:
            conv = new_state["conv"] = conv.to(x.dtype)
        for i, lp in enumerate(_layers(blocks)):
            x, (c, s) = mamba_block(x, lp, cfg,
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


# ------------------------------------------------------------------- loss

def lm_loss(logits, labels, aux=None, aux_weight: float = 0.01):
    """Token cross-entropy (f32) + optional MoE aux loss."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (logz - gold).mean()
    if aux is not None:
        loss = loss + aux_weight * aux / 1.0
    return loss


def lm_loss_chunked(x, params, cfg: ModelConfig, labels, aux=None,
                    aux_weight: float = 0.01, vocab_chunk: int = 16384):
    """Memory-efficient cross-entropy: streams the vocab in chunks of
    ``vocab_chunk`` so the (B, S, V) f32 logits never materialize; each
    chunk runs under a checkpoint, so the backward recomputes it.  The last
    chunk's columns past V score -1e30, as JAX's zero-padded head masked to
    -1e30 does; the head is sliced per chunk instead of padded whole."""
    head = _head(params, cfg)
    V = head.shape[-1]
    nb = -(-V // vocab_chunk)
    B, S, _ = x.shape
    labels = labels.long()

    def body(m, s, gold, i):
        base = i * vocab_chunk
        lg = (x @ head[:, base:base + vocab_chunk]).float()   # (B, S, <=chunk)
        if lg.shape[-1] < vocab_chunk:
            lg = torch.nn.functional.pad(
                lg, (0, vocab_chunk - lg.shape[-1]), value=-1e30)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        off = torch.clamp(labels - base, 0, vocab_chunk - 1)
        g = torch.gather(lg, -1, off[..., None])[..., 0]
        in_chunk = (labels >= base) & (labels < base + vocab_chunk)
        return m_new, s, torch.where(in_chunk, g, gold)

    m = torch.full((B, S), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for i in range(nb):
        m, s, gold = checkpoint(body, m, s, gold, i, use_reentrant=False)
    loss = (torch.log(s) + m - gold).mean()
    if aux is not None:
        loss = loss + aux_weight * aux
    return loss
