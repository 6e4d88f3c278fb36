"""Shared layers: functional, parameters are dicts of tensors.

The PyTorch counterpart of the reference's ``repro/models/layers.py``,
with the same dtype rules: norms and rotary tables compute in float32 and
cast back to the activation dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


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


def _act(name: str, gate: Optional[torch.Tensor], up: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * up
    if name == "gelu_gated":
        return F.gelu(gate, approximate="tanh") * up
    if name == "gelu":
        return F.gelu(up, approximate="tanh")
    if name == "relu2":
        r = F.relu(up)
        return r * r
    raise ValueError(f"unknown act {name}")


def mlp_gated(name: str) -> bool:
    return name in ("silu", "gelu_gated")


def mlp_apply(params: Dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Dense MLP: ``x (..., d) -> (..., d)``."""
    up = x @ params["wi"]
    gate = x @ params["wg"] if "wg" in params else None
    return _act(act, gate, up) @ params["wo"]


def dense_init(gen: torch.Generator, shape, fan_in: int, dtype: torch.dtype) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights, drawn in float32 on the generator's device."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(dtype)  # in place: one float32 copy at a time


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
