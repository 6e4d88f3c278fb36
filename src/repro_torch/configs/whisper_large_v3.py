"""whisper-large-v3 [audio] — enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

32L decoder + 32L encoder, d_model=1280 20H (kv=20, MHA) d_ff=5120
vocab=51866.  The conv/mel frontend is a stub, as in the reference: the
caller hands over 1500 precomputed frame embeddings (``batch["frames"]``).
Decoder self-attention is causal with a cache; cross-attention reads the
encoder output.  The real model caps the decoder at 448 positions;
long_500k is skipped (full attention).
"""

from .base import ModelConfig, AUDIO

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family=AUDIO,
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encoder_layers=32,
    encoder_seq=1500,
    act="gelu",
    rope_theta=0.0,  # sinusoidal absolute positions
)
