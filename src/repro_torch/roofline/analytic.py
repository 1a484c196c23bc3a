"""First-order analytic HBM-traffic model (per chip, per step).

Counterpart of ``repro.roofline.analytic``, the same arithmetic on the
config.  The traced step's ``bytes accessed`` (``roofline.trace``) counts
every aten op's operands at HBM prices, as XLA's ``cost_analysis()`` counts
every instruction's; on a device most of those ops fuse, so the count
overestimates true HBM traffic.  The roofline table therefore carries BOTH:
the traced bytes and this documented first-order model, which drives the
dominant-term call:

train (per chip):
    params:   all-gathered per layer over the FSDP axis → each chip reads the
              TP-shard twice (fwd+bwd) and writes the gathered copy once
              ≈ 6 B/param / TP
    grads:    reduce-scattered: 4 B/param / TP write + 4 B/param / n read
    optimizer: read+write p(2B), m(4B), v(4B) on the 1/n shard → 20 B/param/n
    activations: ~C_ACT tensors of (tokens_loc × d_model) bf16 per layer,
              ×2 for full remat recompute (C_ACT≈14 write+read pairs)
    logits:   fwd bf16 write+read + f32 softmax/grad round trips
              ≈ 12 B × tokens_loc × vocab/TP
decode (per chip):
    params 2 B/TP, KV cache streamed once (2 B × 2 × L × B × S × KV × hd / n),
    SSD states for ssm/hybrid.
prefill: fwd-only params + activations + logits.
"""
from __future__ import annotations

C_ACT = 14  # activation tensors per layer (write+read), empirical first-order


def _dims(mesh_name: str):
    if mesh_name == "multi":
        return 512, 16  # chips, TP(model axis)
    return 256, 16


def analytic_hbm_bytes(cfg, shape, mesh_name: str, remat: str = "full") -> float:
    chips, tp = _dims(mesh_name)
    P = cfg.param_count()
    Pa = cfg.active_param_count()
    d = cfg.d_model
    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    tok_loc = max(1, B * S // chips)

    if shape.kind == "train":
        params = 6.0 * P / tp
        grads = 4.0 * P / tp + 4.0 * P / chips
        opt = 20.0 * P / chips
        remat_mult = 2.0 if remat == "full" else 1.5
        acts = C_ACT * remat_mult * L * tok_loc * d * 2.0
        logits = 12.0 * tok_loc * cfg.vocab / tp
        return params + grads + opt + acts + logits
    if shape.kind == "prefill":
        params = 2.0 * Pa / tp
        acts = (C_ACT / 2) * L * tok_loc * d * 2.0
        logits = 4.0 * tok_loc * cfg.vocab / tp
        return params + acts + logits
    # decode: one token/seq — weight- and cache-streaming bound
    tok_loc = max(1, B // min(B, chips // tp) // 1)  # per-chip rows
    params = 2.0 * Pa / tp
    cache = 0.0
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        n_attn = L if cfg.family != "hybrid" else max(
            1, L // max(1, cfg.shared_attn_every))
        cache += 2.0 * 2.0 * n_attn * B * S * cfg.n_kv_heads * cfg.hd / chips
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        nh = d_in // cfg.ssm_head_dim
        cache += (4.0 + 4.0) * L * B * nh * cfg.ssm_head_dim * \
            cfg.ssm_state / chips
    return params + cache
