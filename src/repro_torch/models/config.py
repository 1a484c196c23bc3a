"""Model configuration for the assigned architecture pool (the port's own
copy of ``repro.models.config``; ``repro_torch`` imports nothing of ``repro``).

One ``ModelConfig`` covers all six families (dense / moe / vlm / hybrid /
audio / ssm); family-specific fields are zero/None when unused.  Input
shapes are the four assigned (seq_len × global_batch) cells.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int              # 0 for attention-free (ssm)
    n_kv_heads: int
    d_ff: int                 # dense FFN hidden (per-expert hidden for MoE)
    vocab: int
    head_dim: int = 0         # default d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (zamba2): a weight-shared attention block every k-th layer
    shared_attn_every: int = 0
    # vlm (llama-3.2-vision): cross-attention to image tokens every k-th layer
    cross_attn_every: int = 0
    n_image_tokens: int = 1601   # 1 tile of 448x448 @ patch 14 (+cls)
    # audio (musicgen): EnCodec codebooks (frontend stub sums embeddings)
    n_codebooks: int = 0
    # which shapes this arch skips (noted in DESIGN.md)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            per = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                   + d_in * d + d_in)
            total += L * per
        else:
            hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
            attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
            if self.family == "moe" and self.n_experts:
                ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            per = attn + ffn + 2 * d
            if self.family == "hybrid":
                # mamba layers + one shared attention block
                d_in = self.ssm_expand * d
                per = (d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim)
                       + d_in * d + 2 * d)
                total += attn + 3 * d * self.d_ff  # the shared block
            total += L * per
            if self.family == "vlm" and self.cross_attn_every:
                n_ca = L // self.cross_attn_every
                total += n_ca * (attn + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts top_k experts only."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        moe_all = L * self.n_experts * 3 * d * self.d_ff
        moe_active = L * self.top_k * 3 * d * self.d_ff
        return full - moe_all + moe_active

    def shapes(self):
        for s in SHAPES.values():
            if s.name not in self.skip_shapes:
                yield s
