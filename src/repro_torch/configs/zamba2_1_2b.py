"""zamba2-1.2b [arXiv:2411.15242; hf]: Mamba2 backbone + shared attention.

38 Mamba2 layers; a single weight-shared (attention + MLP) block is applied
every 6th layer (the Zamba2 shared-block design). Sub-quadratic: runs
long_500k.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6, rope_theta=10000.0,
)
