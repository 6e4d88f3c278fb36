"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs attention and a mamba head in parallel on the same
normed input and sums the branches.  Most layers use sliding-window
attention (sub-quadratic => long_500k applies); one per group of 8 is
global, approximating Hymba's 3-full-attn-layer pattern within the
reference's homogeneous layer groups (the port loops over the same groups).
"""

from .base import ModelConfig, HYBRID

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    global_every=8,
    subquadratic=True,
)
