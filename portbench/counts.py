"""The yardstick's arithmetic: peaks, operation and byte counts, kernel kinds.

These are the benchmark's own copies, frozen here so that a change to the
program cannot move them.  Every count is a function of shapes alone.

* :data:`PEAKS`: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates.
* :func:`prefill_flops`, :func:`train_flops`: the work a forward pass
  needs.  Attention's score and value products are counted over the causal
  triangle (``L (L + 1) / 2`` key positions per head), a MoE layer at its
  ``k`` routed experts a token (not at the capacity slots the program
  computes), the Mamba scan at 6 operations per state element and step.
  Training counts forward plus backward as 3 x forward; remat's recompute
  is not counted.
* :func:`k9_counts`, :func:`k10_counts`, :func:`bound_s`: the least time
  of one launch of the fused scan kernels, the largest of their bytes (each input byte read
  once, each output byte written once) over the HBM rate, their float32
  operations over the float32 rate, and their exponentials over the rate of
  the special-function units.
* :func:`kv_sort_bytes`, :func:`topk_bytes`: the bytes of the sort kernels'
  functions: a key-value sort reads its keys and values once and writes
  them once; a top-k reads its row once and writes its ``k`` values and
  indices once.
* :func:`kind_of`: the kinds of device operation by name.
"""

from __future__ import annotations

from typing import Dict

# one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit)
PEAKS: Dict[str, float] = {
    "bf16_flops": 989e12,  # tensor cores, bfloat16, without sparsity
    "fp32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes": 3.35e12,  # bytes/s, HBM3
    # exponentials a second: 16 per SM per clock, 132 SMs, 1.98 GHz boost
    "sfu_exp": 16 * 132 * 1.98e9,
}

SCAN_OPS_PER_ELEMENT = 6  # decay * h + dt * B * x, then h * C into y


def _attn_layer_flops(cfg: Dict, tokens: int, causal_keys: float) -> float:
    d, h, kv, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    proj = 2.0 * tokens * d * (h + 2 * kv) * hd + 2.0 * tokens * h * hd * d
    core = 2.0 * 2.0 * h * hd * causal_keys  # q k^T and p v over the causal triangle
    return proj + core


def _moe_layer_flops(cfg: Dict, tokens: int) -> float:
    d, e, f, k = cfg["hidden_size"], cfg["num_local_experts"], cfg["intermediate_size"], cfg["num_experts_per_tok"]
    return 2.0 * tokens * d * e + 2.0 * 3.0 * tokens * k * d * f  # router, then k gated experts a token


def _mamba_layer_flops(cfg: Dict, tokens: int) -> float:
    d, di, st = cfg["hidden_size"], cfg["intermediate_size"], cfg["state_size"]
    r, kc = cfg["time_step_rank"], cfg["conv_kernel"]
    mats = 2.0 * tokens * (d * 2 * di + di * (r + 2 * st) + r * di + di * d)
    return mats + 2.0 * tokens * di * kc + SCAN_OPS_PER_ELEMENT * tokens * di * st


def layer_flops(cfg: Dict, seq: int, rows: int = 1) -> float:
    """The forward operations of one layer over ``rows`` sequences of ``seq``."""
    tokens = rows * seq
    if cfg["family"] == "moe":
        causal = rows * seq * (seq + 1) / 2.0
        return _attn_layer_flops(cfg, tokens, causal) + _moe_layer_flops(cfg, tokens)
    if cfg["family"] == "ssm":
        return _mamba_layer_flops(cfg, tokens)
    raise ValueError(f"no count for family {cfg['family']!r}")


def prefill_flops(cfg: Dict, seq: int) -> float:
    """One prompt of ``seq`` tokens: every layer, then the head at the last position."""
    return cfg["num_hidden_layers"] * layer_flops(cfg, seq) + 2.0 * cfg["hidden_size"] * cfg["vocab_size"]


def train_flops(cfg: Dict, rows: int, seq: int) -> float:
    """One training step of ``(rows, seq)``: 3 x (every layer and the head at every position)."""
    fwd = cfg["num_hidden_layers"] * layer_flops(cfg, seq, rows) + 2.0 * rows * seq * cfg["hidden_size"] * cfg[
        "vocab_size"]
    return 3.0 * fwd


# --- the fused scan (K9 forward, K10 backward); element sizes as the program passes them
# (dt float32; x, y, B, C and A in the compute dtype: A_log is rounded to it with every stacked leaf)

def k9_counts(rows: int, seq: int, d: int, st: int, act: int = 2) -> Dict[str, float]:
    """K9 of ``(rows, seq, d)`` with ``st`` states, without checkpoints: bytes,
    float32 operations and exponentials."""
    n = rows * seq
    nbytes = 4 * n * d + act * n * d + act * 2 * n * st + act * d * st  # dt, x, B and C, A in
    nbytes += act * n * d + 4 * rows * d * st  # y and h_final out
    return {"bytes": float(nbytes), "flops": float(SCAN_OPS_PER_ELEMENT * n * d * st), "exp": float(n * d * st)}


def k10_counts(rows: int, seq: int, d: int, st: int, chunk: int, act: int = 2) -> Dict[str, float]:
    """K10, the function's own inputs and outputs: the forward's operands,
    the float32 checkpoints and ``dh_final``, ``dy`` in; ``ddt`` and ``dx``
    (B, S, D), ``dB`` and ``dC`` (B, S, st) and ``dA`` (D, st) out, float32.
    One exponential a state and step (the decay), recomputed."""
    n = rows * seq
    nbytes = 4 * n * d + act * n * d + act * 2 * n * st + act * d * st  # dt, x, B, C, A
    nbytes += 4 * rows * (-(-seq // chunk)) * d * st + 4 * rows * d * st + act * n * d  # checkpoints, dh_final, dy
    nbytes += 4 * (2 * n * d + 2 * n * st + d * st)  # the five gradients
    # the state recomputed (as forward) and the reverse recurrence with its four products
    flops = (SCAN_OPS_PER_ELEMENT + 8) * n * d * st
    return {"bytes": float(nbytes), "flops": float(flops), "exp": float(n * d * st)}


def bound_s(c: Dict[str, float]) -> float:
    """The least time of a call with counts ``c``: the largest of its three bounds."""
    return max(c["bytes"] / PEAKS["hbm_bytes"], c["flops"] / PEAKS["fp32_flops"], c["exp"] / PEAKS["sfu_exp"])


def kv_sort_bytes(n: int, key_bytes: int = 4, value_bytes: int = 4) -> float:
    """A stable key-value sort of ``n`` pairs: read once, written once."""
    return 2.0 * n * (key_bytes + value_bytes)


def topk_bytes(n: int, k: int, key_bytes: int, index_bytes: int = 4) -> float:
    """A top-``k`` of a row of ``n``: the row read once, ``k`` values and indices written once."""
    return float(n * key_bytes + k * (key_bytes + index_bytes))


# --- device operations by kind, matched on their names in this order (the first match wins)
KINDS = (
    ("K10", ("ssm_scan_bwd",)),
    ("K9", ("ssm_scan_kernel",)),
    ("S1", ("sort_tiles_kernel",)),
    ("K3/K4", ("sort_round_seg_kernel",)),
    ("matrix products", ("gemm", "gemv", "nvjet", "cutlass", "sm90_", "splitKreduce")),
    ("copies", ("direct_copy", "Memcpy", "Memset", "memcpy", "memset")),
    ("softmax", ("softmax", "SoftMax")),
    ("reductions", ("reduce_kernel", "logsumexp")),
    ("elementwise", ("elementwise",)),
)


def kind_of(name: str) -> str:
    """The kind (:data:`KINDS`) of a device operation, by its name; "other" if none."""
    return next((k for k, pats in KINDS if any(p in name for p in pats)), "other")


def is_k4(name: str) -> bool:
    """K4 is the sort round's template with values (its second argument ``true``); K3 the one without."""
    if "sort_round_seg_kernel" not in name:
        return False
    args = name.split("sort_round_seg_kernel", 1)[1]
    return "true" in args.split(">", 1)[0] if "<" in args else False
