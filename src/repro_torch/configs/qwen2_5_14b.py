"""qwen2.5-14b [hf:Qwen/Qwen2.5-0.5B family; hf]: GQA + QKV bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1000000.0,
    skip_shapes=("long_500k",),
)
