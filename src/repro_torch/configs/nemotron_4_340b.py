"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  relu^2 MLP
(no gating).  Its float32 masters and moments outgrow one pod of the
reference's dry-run mesh, so FSDP extends over the pod axis
(``fsdp_over_pod=True``).  Its bfloat16 weights alone are about 680 GB,
so on one card it runs only cut in depth.
"""

from .base import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family=DENSE,
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    act="relu2",
    tie_embeddings=False,
    fsdp_over_pod=True,
)
