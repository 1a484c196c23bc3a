"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, n_experts=40, top_k=8,
    rope_theta=10000.0, tie_embeddings=True,
    skip_shapes=("long_500k",),
)
