"""Model configuration: the port's own copy of the reference's dataclass.

``ModelConfig`` is a frozen dataclass describing one architecture.  The
field set and the two derived counts (``n_params``, ``n_active_params``)
match the JAX package's ``repro.configs.base`` field for field, so a
config built here describes the same model there.  ``reduced()`` returns
a tiny same-family config for CPU tests (same code paths, small dims).
``ShapeConfig``/``SHAPES`` (the reference's named batch shapes),
``shape_applicable`` (which of them an architecture runs) and
``TrainConfig`` (the optimizer and run knobs) are copies too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Families
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
VLM = "vlm"
AUDIO = "audio"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0  # dense shared-expert MLP width (0 = none)
    # the routing sort of MoE dispatch, the reference's three values:
    # "merge_path" (the plain batched sort of repro_torch.core:
    # merge_sort_kv_batched{,_ragged}) | "merge_path_pallas" (the hand-written
    # tile sort S1 and sort round K4 through repro_torch.kernels.ops.sort_kv_batched)
    # | "cumsum" (one-hot cumsum positions, the ablation)
    moe_dispatch: str = "merge_path"

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128  # chunked-scan block (materialization/compile trade)
    # "scan" (chunked scan, plain PyTorch) | "fused" (the hand-written
    # selective-scan kernels, repro_torch.kernels.ssm_scan: K9 forward, K10
    # backward)
    ssm_backend: str = "scan"

    # --- attention pattern ---
    sliding_window: int = 0  # 0 = all-global full attention
    global_every: int = 0  # gemma3: one global layer per `global_every`; 0 = all global
    attn_chunk: int = 1024  # kv-chunk for blockwise attention on long sequences
    attn_logit_softcap: float = 0.0

    # --- enc-dec / multimodal frontends (stubs provide embeddings) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # whisper: 1500 frames
    num_prefix_tokens: int = 0  # paligemma: 256 patch embeddings

    # --- misc ---
    act: str = "silu"  # silu (gated) | relu2 (nemotron) | gelu (whisper)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"
    # nemotron-340B optimizer state exceeds one pod: shard FSDP over pod too
    fsdp_over_pod: bool = False
    remat: bool = True
    # --- beyond-paper perf knobs (§Perf hillclimb; defaults = baseline) ---
    train_attn_blockwise: bool = False  # online-softmax attention in training
    ssm_scan_dtype: str = "float32"  # associative-scan element dtype (bf16 halves bytes)
    remat_policy: str = "full"  # full | dots (save matmul outputs, recompute the rest)
    replicate_kv_proj: bool = False  # replicate wk/wv output dim (MQA/GQA with few kv heads)
    # long_500k applicability (sub-quadratic decode path exists)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, math.ceil(self.d_model / 16))

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def layer_group(self) -> int:
        """Scan unit: layers are scanned in homogeneous groups."""
        return self.global_every if self.global_every > 0 else 1

    def n_params(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if self.family != SSM:
            per_layer += d * (self.num_heads + 2 * self.num_kv_heads) * hd
            per_layer += self.num_heads * hd * d
        if self.family in (SSM, HYBRID):
            di, st = self.d_inner, self.ssm_state
            per_layer += d * 2 * di + di * self.ssm_conv
            per_layer += di * (self.dt_rank + 2 * st) + self.dt_rank * di
            per_layer += di * st + di + di * d
        if self.num_experts:
            e, fe = self.num_experts, self.d_ff
            per_layer += d * e  # router
            per_layer += e * (3 * d * fe)
            if self.shared_expert_ff:
                per_layer += 3 * d * self.shared_expert_ff
        elif self.d_ff:
            mult = 3 if self.act in ("silu", "gelu_gated") else 2  # gated adds wg
            per_layer += mult * d * self.d_ff
        per_layer += 2 * d  # norms
        n += self.num_layers * per_layer
        if self.encoder_layers:
            enc = d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d
            enc += (3 if self.act in ("silu", "gelu_gated") else 2) * d * self.d_ff + 2 * d
            # + cross attention in decoder (already counted? add q/kv/o again)
            n += self.encoder_layers * enc
            n += self.num_layers * (d * (self.num_heads + 2 * self.num_kv_heads) * hd + self.num_heads * hd * d + d)
        n += d  # final norm
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.n_params()
        d, fe = self.d_model, self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * 3 * d * fe
        return self.n_params() - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=max(2, self.layer_group),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            shared_expert_ff=64 if self.shared_expert_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_chunk=8,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            attn_chunk=32,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=24 if self.encoder_seq else 0,
            num_prefix_tokens=8 if self.num_prefix_tokens else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell runs; reason string when skipped."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode is quadratic-cost/HBM-infeasible (per spec, skipped)"
    return True, ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / runtime knobs (the run config half of the system)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    microbatch: int = 0  # 0 = no gradient accumulation
    # gradient compression with error feedback (repro_torch.parallel.compression)
    grad_compression: str = "none"  # none | topk | int8
    compression_topk: float = 0.01
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    seed: int = 0
