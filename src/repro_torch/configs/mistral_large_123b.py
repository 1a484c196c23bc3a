"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768, rope_theta=1000000.0,
    skip_shapes=("long_500k",),
)
