"""Shared layers: functional, parameters are dicts of tensors.

The PyTorch counterpart of the reference's ``repro/models/layers.py``,
with the same dtype rules: norms, rotary and sinusoidal tables compute in
float32 and cast back to the activation dtype, and the activations round
each step as the reference's do (``_gelu``).
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.parallel.sharding import constrain, contiguous_shards


def profiler_range(name: str):
    """A profiler range while ``torch.profiler`` records (so that
    ``launch/profile.py`` can split a prefill's device time by the part of
    the model that ran it), else nothing."""
    return record_function(name) if torch.autograd._profiler_enabled() else contextlib.nullcontext()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def make_rope(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary tables for integer ``positions`` (any shape): ``(sin, cos)``,
    float32, with trailing dim ``head_dim // 2``."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., heads, head_dim) by ``sin``/``cos`` (..., head_dim // 2),
    broadcast over the heads axis."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(num_pos: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings ``(num_pos, d)``,
    float32; the frequencies' denominator is ``max(1, half - 1)``, not
    ``half`` as in the rotary tables."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(half, dtype=torch.float32, device=device) / max(1, half - 1))
    angles = torch.arange(num_pos, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` (the tanh form), step by step in
    ``x``'s dtype: ``x * x * x``, the constants rounded to that dtype, and
    the reference's order of operations.  In bfloat16 every step rounds,
    as there; ``F.gelu(approximate="tanh")`` rounds once and differs in
    about 43 % of bfloat16 outputs (ROADMAP.md, R11)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2.0 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def _act(name: str, gate: Optional[torch.Tensor], up: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * up
    if name == "gelu_gated":
        return _gelu(gate) * up
    if name == "gelu":
        return _gelu(up)
    if name == "relu2":
        r = F.relu(up)
        return r * r
    raise ValueError(f"unknown act {name}")


def mlp_gated(name: str) -> bool:
    return name in ("silu", "gelu_gated")


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Dense MLP: ``x (..., d) -> (..., d)``."""
    with profiler_range("model.mlp"):
        up = x @ params["wi"]
        gate = x @ params["wg"] if "wg" in params else None
        return contiguous_shards(constrain(_act(act, gate, up), "act_batch", "act_seq", "act_ff")) @ params["wo"]


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in float32 on the generator's
    device; on :data:`META` a meta tensor, nothing drawn."""
    w = torch.randn(shape, generator=None if gen is META else gen, dtype=torch.float32, device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(dtype)  # in place: one float32 copy at a time


# stands in for the generator of the init functions to build a parameter tree
# of meta tensors: the reference's shapes and dtypes, nothing allocated or drawn
# (a torch.Generator cannot live on the meta device)
META = SimpleNamespace(device=torch.device("meta"))


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype, lead=()) -> Dict:
    """MLP weights; ``lead`` prepends stacking axes (e.g. ``(num_layers,)``)."""
    lead = tuple(lead)
    p = {
        "wi": dense_init(gen, lead + (d_model, d_ff), d_model, dtype),
        "wo": dense_init(gen, lead + (d_ff, d_model), d_ff, dtype),
    }
    if mlp_gated(act):
        p["wg"] = dense_init(gen, lead + (d_model, d_ff), d_model, dtype)
    return p
