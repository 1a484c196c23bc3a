"""musicgen-large [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (4 codebooks summed), per the assignment note.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, n_codebooks=4, rope_theta=10000.0,
    skip_shapes=("long_500k",),
)
