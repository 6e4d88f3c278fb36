"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16, MHA) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6 + shared expert.  MoE dispatch is the merge-path
stable kv-sort (the paper's technique as a first-class feature).
28.55 B parameters, 57.1 GB in bfloat16: served whole on one 80 GB card.
"""

from .base import ModelConfig, MOE

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    shared_expert_ff=2816,
    capacity_factor=1.25,
)
