"""yi-6b [dense] — llama-arch GQA [arXiv:2403.04652; hf].

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from .base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="yi-6b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    tie_embeddings=False,
)
