"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B; hf]: 48L MoE 128e top-8."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, n_experts=128, top_k=8, qk_norm=True,
    rope_theta=1000000.0,
    skip_shapes=("long_500k",),   # full attention: 500k decode skipped
)
