"""gemma3-12b [dense] — 5:1 local:global, 128k context
[hf:google/gemma-3-1b-pt; unverified].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.  Layers scan in
groups of 6 (5 sliding-window 1024 + 1 global) — the 5:1 interleave.
Sliding-window majority => long_500k decode is run (global layers hold
the full cache, context-parallel over the model axis).
"""

from .base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="gemma3-12b",
    family=DENSE,
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    attn_logit_softcap=0.0,
    rope_theta=1_000_000.0,
    subquadratic=True,
)
