"""llama3-405b [arXiv:2407.21783; unverified]: 126L GQA 128k vocab."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, rope_theta=500000.0,
    skip_shapes=("long_500k",),
)
