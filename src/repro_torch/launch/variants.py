"""Named sharding variants for §Perf hillclimbing (counterpart of
``repro.launch.variants``, the same table edits).

Each variant is one edit to the logical rules table; the dry-run records it
so before/after roofline terms are directly comparable.
"""
from __future__ import annotations

from typing import Dict


def apply_variant(rules: Dict, arch: str, shape: str, variant: str) -> Dict:
    rules = dict(rules)
    if variant == "baseline":
        return rules
    if variant == "fsdp_pod":
        # FSDP over (pod, data) instead of data only — param all-gathers
        # cross pods; trades collective for memory headroom.
        rules["embed"] = ("pod", "data")
        return rules
    if variant == "no_fsdp":
        # replicate params over data (pure DP + TP): kills the per-layer
        # all-gathers, costs memory.
        rules["embed"] = None
        return rules
    if variant == "seq_shard":
        # Megatron-style sequence parallelism: between blocks, activations
        # are sharded on the SEQ dim over the model axis; XLA inserts
        # all-gather before attention/MLP and reduce-scatter after — same
        # wire bytes as the 2 all-reduces but the inter-block activations
        # (and their remat copies) shrink by the TP degree.
        rules["seq"] = "model"
        rules["act_embed"] = None
        return rules
    if variant == "ep_capacity":
        # MoE: shard the dispatch buffer's capacity dim over data — the
        # expert GEMMs compute per-chip capacity (1/16 of global) and the
        # token→expert movement becomes a proper all-to-all.
        rules["moe_capacity"] = "data"
        return rules
    if variant == "ep_only":
        # MoE: keep expert parallelism (experts over model) but drop tensor
        # parallelism for attention/dense/vocab — kills the per-layer
        # activation all-reduces; attention params get FSDP over both axes.
        for k in ("heads", "kv_heads", "ffn", "vocab", "embed_vocab",
                  "act_heads", "act_ffn", "act_vocab"):
            rules[k] = None
        rules["embed"] = ("data", "model")
        return rules
    if variant == "expert_data":
        # experts sharded over (data, model) — more expert parallelism for
        # big-E MoE, fewer experts per chip.
        rules["experts"] = ("data", "model")
        return rules
    if variant == "vocab_data":
        # shard the vocab/lm_head over (data, model): halves the logits
        # all-reduce payload per axis.
        rules["vocab"] = ("data", "model")
        rules["act_vocab"] = ("data", "model")
        return rules
    if variant == "cache_seq_model":
        # decode: KV cache sequence dim over model axis instead of batch TP
        rules["cache_seq"] = "model"
        rules["kv_heads"] = None
        return rules
    if variant == "pure_fsdp":
        # No tensor parallelism: both mesh axes act as FSDP/DP.  Kills the
        # 2-per-layer Megatron all-reduces of full activations; params are
        # fully sharded and all-gathered per layer instead.  Right when
        # (param bytes × 3 passes) < (2 × tokens_loc × d × L × 2 AR passes).
        for k in ("heads", "kv_heads", "ffn", "experts", "vocab",
                  "embed_vocab", "ssm_inner", "ssm_heads", "act_heads",
                  "act_ffn", "act_experts", "act_vocab"):
            rules[k] = None
        rules["embed"] = ("data", "model")
        rules["batch"] = ("pod", "data", "model")
        rules["cache_batch"] = ("pod", "data", "model")
        return rules
    if variant == "batch_dp":
        # batch shards over (pod, data) only — required when microbatching
        # shrinks the per-microbatch batch below the full device count.
        rules["batch"] = ("pod", "data")
        rules["cache_batch"] = ("pod", "data")
        return rules
    if variant == "embed_replicated":
        # Replicate the embedding TABLE over model (lm_head stays sharded):
        # removes the involuntary-rematerialization resharding XLA reports
        # on the vocab-sharded gather.
        rules["embed_vocab"] = None
        return rules
    if variant == "decode_weights_stationary":
        # Decode: no FSDP on params (weights stay resident; batch is tiny so
        # the per-layer weight all-gathers dominate otherwise) + KV cache
        # sequence-sharded over the model axis (4 KV heads cannot split a
        # 16-way axis; the seq dim can).
        rules["embed"] = None
        rules["cache_seq"] = "model"
        rules["kv_heads"] = None
        return rules
    raise KeyError(f"unknown variant {variant!r}")
