"""The model: specs, forward and decode for all six families (torch).

Counterpart of ``repro.models.transformer``:

  dense/audio : attention + SwiGLU per layer (audio takes precomputed frame
                embeddings through ``inputs_embeds``: the EnCodec frontend
                is a stub, as in JAX)
  moe         : attention + top-k expert FFN per layer, aux loss summed over
                the layers
  vlm         : dense layers + gated cross-attention to (stub) image
                embeddings every ``cross_attn_every`` layers
  ssm         : Mamba2 SSD block per layer
  hybrid      : Mamba2 block per layer + one weight-SHARED attention/MLP
                block fired every ``shared_attn_every`` layers (the Zamba2
                design)

A Python loop over the stacked ``(L, ...)`` layer params takes the place of
``lax.scan``, each leaf unbound once per call (``torch.unbind``: its
backward stacks the layers' grads once, where indexing ``v[i]`` would
allocate a zero tensor the size of the whole stack for every layer).
``remat`` maps ``jax.checkpoint`` per layer to ``torch.utils.checkpoint``
(non-reentrant): ``"full"`` recomputes the layer, ``"dots"`` saves its
``aten.mm`` outputs (``dots_with_no_batch_dims_saveable``: MoE's router
product is saved, its batched expert products recomputed), ``"none"``
checkpoints nothing; the final norm and the head stay outside, as in JAX.
``lm_loss`` and ``lm_loss_chunked`` are the training losses.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import is_dtensor
from ..kernels import flash_attention, rmsnorm
from ..kernels._local import head_on_shards, vocab_on_shards
from ..sharding.context import carried, constrain, replicated_like, whole
from ..sharding.rules import CACHE_AXES, INPUT_AXES, distribute_inputs
from .config import ModelConfig
from .layers import (attention, attention_specs, embed_rows, matmul,
                     merge_heads, mlp_specs, promoted, split_heads, swiglu,
                     write_state)
from .moe import moe_ffn, moe_specs
from .params import p, tree_abstract, tree_init
from .ssm import init_ssm_state, mamba_block, ssm_specs

FAMILIES = ("dense", "audio", "vlm", "moe", "ssm", "hybrid")
REMAT_POLICIES = ("none", "full", "dots")


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ------------------------------------------------------------------ specs

def build_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _require_family(cfg)
    d, L = cfg.d_model, cfg.n_layers
    specs: Dict[str, Any] = {
        "embed": p((cfg.vocab, d), ("embed_vocab", "embed"), scale=1.0),
        "final_norm": p((d,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = p((d, cfg.vocab), ("embed", "vocab"))
    if cfg.family in ("dense", "audio", "vlm"):
        specs["blocks"] = {**attention_specs(cfg, L), **mlp_specs(cfg, L)}
    elif cfg.family == "moe":
        specs["blocks"] = {**attention_specs(cfg, L), **moe_specs(cfg, L)}
    else:
        specs["blocks"] = ssm_specs(cfg, L)
    if cfg.family == "hybrid":
        shared = {**attention_specs(cfg, 1), **mlp_specs(cfg, 1)}
        specs["shared"] = {k: p(v.shape[1:], v.axes[1:], v.init, v.scale)
                           for k, v in shared.items()}
    if cfg.family == "vlm":
        n_ca = cfg.n_layers // cfg.cross_attn_every
        ca = {f"ca_{k}": v for k, v in attention_specs(cfg, n_ca).items()}
        ca["ca_gate"] = p((n_ca,), ("layers",), init="zeros")
        specs["cross"] = ca
    return specs


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                each=None):
    """Random parameters on ``device`` (default: the generator's device);
    a full-width model is initialised on the card with a CUDA generator.
    ``each(path, leaf)`` replaces each leaf as it is drawn (``tree_init``:
    a rank keeps its shard)."""
    return tree_init(build_specs(cfg), generator, device, each)


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
    """``fn`` under the per-layer checkpoint that ``remat`` names.  The
    checkpointed function carries the sharding context it was wrapped in
    (``carried``): the recompute runs in autograd's thread, where the
    context is unset, and must constrain as the forward did."""
    if remat == "none":
        return fn
    fn = carried(fn)
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_mm))
    raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")


def _head(params, cfg: ModelConfig):
    """The output projection: ``lm_head``, or the embedding table's
    transpose.  A tied DTensor table whose vocabulary no mesh dimension
    splits (49155 rows over 16 ranks) takes the head's gradient back at its
    own placements first (an identity redistribution): the head's product
    may leave it split along the vocabulary, and the embedding's gradient
    arrives at the table's placements, a sum torch 2.11's DTensor cannot
    form (it would move a shard to a pending sum)."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    table = params["embed"]
    if is_dtensor(table):
        from torch.distributed.tensor import Shard
        if not any(isinstance(q, Shard) and q.dim % table.ndim == 0
                   for q in table.placements):
            table = table.redistribute(table.device_mesh, table.placements)
    return table.T


def _head_product(name: str, x, head):
    """``x @ head`` in the promoted type; DTensor operands go through
    ``head_on_shards``, which forms the head's weight gradient from each
    rank's own rows."""
    if is_dtensor(x):
        return head_on_shards(name, *promoted(x, head))
    return matmul(x, head)


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


def _fires_cross(cfg: ModelConfig, i: int) -> bool:
    return cfg.family == "vlm" and i % cfg.cross_attn_every == 0


def _cross_index(cfg: ModelConfig, i: int, n_ca: int) -> int:
    """The cross layer that layer ``i`` uses: ``i // cross_attn_every``,
    clamped to the last one as ``lax.dynamic_index_in_dim`` clamps it (with
    ``n_layers % cross_attn_every != 0`` the last firing layer reuses it)."""
    return min(i // cfg.cross_attn_every, n_ca - 1)


def _cross_attention(x, cap, cfg: ModelConfig, img_kv,
                     force_ref: bool = False):
    """Gated cross-attention to precomputed image K/V (one layer's params):
    no RoPE, no q/k norm, full (non-causal) attention over the image.
    Across ranks the flash call runs on each rank's batch rows and heads
    (``heads_on_shards``) and the gate is a replicated 0-d slice."""
    H, hd = cfg.n_heads, cfg.hd
    h = rmsnorm(x, cap["ca_attn_norm"], cfg.norm_eps, force_ref=force_ref)
    q = split_heads(matmul(h, cap["ca_wq"]), H, hd)
    k, v = img_kv                                     # (B, n_img, KV, hd)
    attn = flash_attention(q, k, v, causal=False, force_ref=force_ref)
    out = matmul(merge_heads(attn), cap["ca_wo"])
    gate = torch.tanh(cap["ca_gate"].float()).to(x.dtype)
    return out * gate


def _image_kv(cross, cfg: ModelConfig, img_embeds):
    """Cross-attention K and V of every cross layer, from one stacked
    product each: ``((n_ca, B, n_img, KV, hd),) * 2``, contiguous (einsum
    may return a permuted view; each layer's slice goes to the kernel).
    On DTensors each weight's contraction dimension is gathered (``whole``)
    and its KV head columns kept, so each rank computes its batch rows'
    K / V of its heads, one product a cross layer; the result takes
    ``CACHE_AXES["img_kv"]``'s placements (the cross-layer stack whole:
    each layer's slice is local)."""
    KV, hd = cfg.n_kv_heads, cfg.hd

    def proj(w):                                      # w: (n_ca, d, KV * hd)
        img, w = promoted(img_embeds, whole(w, 1))
        if is_dtensor(w):
            # einsum's one product flattens (layer, column) pairs, which
            # DTensor refuses where the columns are split: a product a layer
            kv = torch.stack([img @ wc for wc in torch.unbind(w)])
        else:
            kv = torch.einsum("bnd,cde->cbne", img, w).contiguous()
        return constrain(split_heads(kv, KV, hd), CACHE_AXES["img_kv"])
    return proj(cross["ca_wk"]), proj(cross["ca_wv"])


def _embed(params, tokens, inputs_embeds):
    """The layers' input: ``inputs_embeds`` cast to bf16 whatever the
    params' type (as JAX casts it), else the embedding rows of ``tokens``;
    contiguous, as the kernels take it (a caller's one-frame slice of a
    longer sequence is not)."""
    if inputs_embeds is not None:
        return inputs_embeds.to(torch.bfloat16).contiguous()
    return embed_rows(params["embed"], tokens)


# ------------------------------------------------------------------ forward

def forward(params, cfg: ModelConfig, tokens=None, *, inputs_embeds=None,
            img_embeds=None, remat: str = "full", force_ref: bool = False,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward (train / prefill).  Returns (logits, aux_loss),
    or (final-normed hidden states, aux_loss) with ``return_hidden``.
    ``inputs_embeds`` (B, S, d) replaces the token embedding (audio's frame
    embeddings); ``img_embeds`` (B, n_image_tokens, d) are a vlm's image
    embeddings, zeros in the activations' type when not given (across
    ranks, placed as a given image would be)."""
    _require_family(cfg)
    x = constrain(_embed(params, tokens, inputs_embeds),
                  ("batch", "seq", "act_embed"))
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device)
    aux = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    cross, img_k, img_v = [], None, None
    if cfg.family == "vlm":
        if img_embeds is None:
            img_embeds = constrain(replicated_like(torch.zeros(
                (B, cfg.n_image_tokens, d), dtype=x.dtype, device=x.device),
                x), INPUT_AXES["img_embeds"])
        # one unbind each, as ``_layers`` does: a gradient of slices taken
        # one at a time would write the whole stack once a cross layer
        img_k, img_v = map(torch.unbind, _image_kv(params["cross"], cfg,
                                                   img_embeds))
        cross = _layers(params["cross"])

    def body(x, lp, i):
        a = None                         # the layer's MoE aux loss
        if cfg.family in ("ssm", "hybrid"):
            x, _ = mamba_block(x, lp, cfg, force_ref=force_ref)
            x = constrain(x, ("batch", "seq", "act_embed"))
        else:
            out, _ = attention(x, lp, cfg, positions=positions,
                               force_ref=force_ref)
            x = constrain(x + out, ("batch", "seq", "act_embed"))
            if cfg.family == "moe":
                ffn, a = moe_ffn(x, lp, cfg, force_ref=force_ref)
            else:
                ffn = swiglu(x, lp, cfg, force_ref=force_ref)
            x = constrain(x + ffn, ("batch", "seq", "act_embed"))
        if _fires_shared(cfg, i):
            x, _ = _shared_block(x, params["shared"], cfg, positions,
                                 force_ref=force_ref)
        if _fires_cross(cfg, i):
            c = _cross_index(cfg, i, len(cross))
            x = x + _cross_attention(x, cross[c], cfg, (img_k[c], img_v[c]),
                                     force_ref=force_ref)
        return x, a

    layer = _remat(body, remat)
    for i, lp in enumerate(_layers(params["blocks"])):
        x, a = layer(x, lp, i)
        if a is not None:
            aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    if return_hidden:
        return x, aux
    return constrain(_head_product("lm_head", x, _head(params, cfg)),
                     ("batch", "seq", "act_vocab")), aux


# ------------------------------------------------------------------ decode

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device="cuda", img_embeds=None,
                      params=None) -> Dict[str, Any]:
    """Decode cache (zeros).  dense, audio, vlm and moe: k/v (L, B, max_seq,
    KV, hd) in bf16 whatever the params' type; ssm/hybrid: conv (L, B, W-1,
    conv_ch) in bf16 and ssd (L, B, nh, p, n) in f32; hybrid also
    shared_k/v (n_inv, B, max_seq, KV, hd) in bf16, n_inv = ceil(L / every);
    vlm also img_kv, a (k, v) pair of (n_ca, B, n_image_tokens, KV, hd):
    ``_image_kv`` of ``img_embeds`` when both they and ``params`` are given
    (a plain image beside DTensor params is placed by ``INPUT_AXES``
    first), else bf16 zeros.  ``pos`` is a Python int shared by the whole
    batch, as the JAX scalar is (on a mesh of more than one rank, a
    replicated 0-d DTensor: ``decode_state_shardings``)."""
    _require_family(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    state: Dict[str, Any] = {"pos": 0}

    def kv(n, seq=max_seq):
        return torch.zeros((n, batch, seq, KV, hd), dtype=torch.bfloat16,
                           device=device)
    if cfg.family in ("dense", "audio", "vlm", "moe"):
        state["k"], state["v"] = kv(L), kv(L)
    else:
        conv, ssd_st = init_ssm_state(cfg, batch, device=device)
        state["conv"] = conv[None].repeat(L, 1, 1, 1)
        state["ssd"] = ssd_st[None].repeat(L, 1, 1, 1, 1)
    if cfg.family == "hybrid":
        n_inv = -(-L // cfg.shared_attn_every)
        state["shared_k"], state["shared_v"] = kv(n_inv), kv(n_inv)
    if cfg.family == "vlm":
        if params is not None and img_embeds is not None:
            w = params["cross"]["ca_wk"]
            if is_dtensor(w) and not is_dtensor(img_embeds):
                img_embeds = distribute_inputs({"img_embeds": img_embeds},
                                               w.device_mesh)["img_embeds"]
            state["img_kv"] = _image_kv(params["cross"], cfg, img_embeds)
        else:
            z = kv(L // cfg.cross_attn_every, cfg.n_image_tokens)
            state["img_kv"] = (z, z)
    return state


def _positions(pos):
    """(this step's position as an int, the state's next ``pos``): an int
    or 0-d tensor gives ``pos + 1`` as an int, a 0-d DTensor a replicated
    one."""
    if not is_dtensor(pos):
        return int(pos), int(pos) + 1
    now = int(pos.to_local())
    return now, replicated_like(torch.tensor(now + 1, dtype=torch.int32,
                                             device=pos.device), pos)


def decode_step(params, cfg: ModelConfig, state, tokens=None, *,
                inputs_embeds=None,
                force_ref: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for every sequence in the batch: tokens (B, 1), or
    ``inputs_embeds`` (B, 1, d) cast to bf16 as in ``forward``.

    The stacked caches in ``state`` (k/v; conv, ssd and shared_k/v) are
    updated in place (the JAX version returns new arrays; copying a cache
    per step would double its traffic); the returned state is a new dict
    holding the same cache tensors and ``pos + 1``.  One exception, as in
    JAX, where the scan's output takes the activations' type: a conv state
    of another dtype than the activations (bf16 zeros under f32 weights) is
    replaced by a converted copy on the first step.  A vlm's cross-attention
    reads ``img_kv`` through the flash kernel (q of one row, non-causal), as
    JAX runs ``flash_attention`` there."""
    _require_family(cfg)
    x = _embed(params, tokens, inputs_embeds)
    pos, new_pos = _positions(state["pos"])
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    blocks = params["blocks"]
    new_state = dict(state, pos=new_pos)
    if cfg.family in ("dense", "audio", "vlm", "moe"):
        cross = _layers(params["cross"]) if cfg.family == "vlm" else []
        for i, lp in enumerate(_layers(blocks)):
            out, _ = attention(x, lp, cfg, positions=positions,
                               cache=(state["k"][i], state["v"][i]),
                               cache_len=pos, force_ref=force_ref)
            x = x + out
            if cfg.family == "moe":
                x = x + moe_ffn(x, lp, cfg, force_ref=force_ref)[0]
            else:
                x = x + swiglu(x, lp, cfg, force_ref=force_ref)
            if _fires_cross(cfg, i):
                c = _cross_index(cfg, i, len(cross))
                img_k, img_v = state["img_kv"]
                x = x + _cross_attention(x, cross[c], cfg,
                                         (img_k[c], img_v[c]),
                                         force_ref=force_ref)
    else:
        conv, ssd_st = state["conv"], state["ssd"]
        if conv.dtype != x.dtype:
            conv = new_state["conv"] = conv.to(x.dtype)
        for i, lp in enumerate(_layers(blocks)):
            x, (c, s) = mamba_block(x, lp, cfg,
                                    state=(conv[i], ssd_st[i]),
                                    force_ref=force_ref)
            write_state(conv[i], c)
            write_state(ssd_st[i], s)
            if _fires_shared(cfg, i):
                inv = i // cfg.shared_attn_every
                x, _ = _shared_block(
                    x, params["shared"], cfg, positions,
                    cache=(state["shared_k"][inv], state["shared_v"][inv]),
                    cache_len=pos, force_ref=force_ref)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, force_ref=force_ref)
    return matmul(x, _head(params, cfg)), new_state


# ------------------------------------------------------------------- loss

def lm_loss(logits, labels, aux=None, aux_weight: float = 0.01):
    """Token cross-entropy (f32) + optional MoE aux loss.  DTensor logits
    go through ``vocab_on_shards``: each rank reads its own block of the
    vocab, whose rows' maxima, sums and gold logits the ranks combine, and
    takes the logits' gradient on that block."""
    if is_dtensor(logits):
        m, s, gold = vocab_on_shards("lm_loss", logits, labels)
        loss = (torch.log(s) + m - gold).mean()
    else:
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
    -1e30 does; the head is sliced per chunk instead of padded whole.
    Across ranks each chunk goes through ``vocab_on_shards``, as
    ``lm_loss`` does (each rank's own columns of the chunk, never
    gathered), and its statistics fold into the running ones, which take
    the labels' placements, the batch's; the padding is left out there,
    where each of its columns would add exp(-1e30 - m) = 0 to the sum and
    is never the max or a label."""
    head = _head(params, cfg)
    V = head.shape[-1]
    nb = -(-V // vocab_chunk)
    labels = labels.long()

    def body(m, s, gold, i):
        base = i * vocab_chunk
        lg = _head_product("lm_head_chunk", x,
                           head[:, base:base + vocab_chunk])
        if is_dtensor(lg):
            mc, sc, gc = vocab_on_shards("lm_loss_chunk", lg, labels, base)
            m_new = torch.maximum(m, mc)
            s = s * torch.exp(m - m_new) + sc * torch.exp(mc - m_new)
            return m_new, s, gold + gc
        lg = lg.float()
        if lg.shape[-1] < vocab_chunk:
            lg = torch.nn.functional.pad(
                lg, (0, vocab_chunk - lg.shape[-1]), value=-1e30)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        off = torch.clamp(labels - base, 0, vocab_chunk - 1)
        g = torch.gather(lg, -1, off[..., None])[..., 0]
        in_chunk = (labels >= base) & (labels < base + vocab_chunk)
        return m_new, s, torch.where(in_chunk, g, gold)

    m = torch.full_like(labels, -1e30, dtype=torch.float32)
    s = torch.zeros_like(labels, dtype=torch.float32)
    gold = torch.zeros_like(labels, dtype=torch.float32)
    body = carried(body)         # the recompute runs in autograd's thread
    for i in range(nb):
        m, s, gold = checkpoint(body, m, s, gold, i, use_reentrant=False)
    loss = (torch.log(s) + m - gold).mean()
    if aux is not None:
        loss = loss + aux_weight * aux
    return loss
