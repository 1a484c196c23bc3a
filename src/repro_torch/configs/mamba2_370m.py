"""mamba2-370m [arXiv:2405.21060; unverified]: attention-free SSD."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64,
)
