"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726; hf].

18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384 vocab=257216.  The SigLIP
frontend is a stub, as in the reference: the caller hands over 256
precomputed patch embeddings (``batch["prefix_emb"]``), which are
linearly projected and prefixed (PrefixLM mask: bidirectional over the
prefix, causal over the text).
"""

from .base import ModelConfig, VLM

CONFIG = ModelConfig(
    name="paligemma-3b",
    family=VLM,
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    num_prefix_tokens=256,
    act="gelu",
)
