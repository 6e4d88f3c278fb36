"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free [arXiv:2410.05355; unverified].

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand=2
(d_inner=8192), conv4.  O(1)-state decode => long_500k applies.
"""

from .base import ModelConfig, SSM

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family=SSM,
    num_layers=64,
    d_model=4096,
    num_heads=1,  # unused (attention-free)
    num_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    subquadratic=True,
)
