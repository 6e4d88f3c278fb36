"""Weights made from the seed, on the device, in the port's parameter layout.

The benchmark makes the weights itself and hands the same tensors to the
program and to the reference.  The layout (:func:`layout`) is the port's:
every layer parameter stacked on a leading layer axis, the head tied to
the embedding.  Each leaf is drawn by a generator of its own, seeded from
the run's seed and the leaf's index, so one leaf can be drawn again
(:func:`leaf`) without the others: the training cell's check reads the
starting point of each leaf that way.

Initialisation: matrices N(0, 1/fan_in); norm weights N(0, 0.1^2) (the
port scales by ``1 + w``); a Mamba block's ``A_log = log(1..state)``,
``D = 1`` and ``dt_bias`` the inverse softplus of a step size
log-uniform in [1e-3, 1e-1], the Mamba initialisation.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, int]  # path, shape, rule, fan_in


def layout(cfg: Dict) -> List[Leaf]:
    """The leaves of the parameter tree, in the port's order."""
    d, v, n = cfg["hidden_size"], cfg["vocab_size"], cfg["num_hidden_layers"]
    out: List[Leaf] = [(("embed", "table"), (v, d), "normal", d), (("final_norm",), (d,), "norm", 0),
                       (("layers", "attn_norm"), (n, d), "norm", 0)]
    if cfg["family"] == "moe":
        h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        e, f = cfg["num_local_experts"], cfg["intermediate_size"]
        out += [
            (("layers", "attn", "wq"), (n, d, h * hd), "normal", d),
            (("layers", "attn", "wk"), (n, d, kv * hd), "normal", d),
            (("layers", "attn", "wv"), (n, d, kv * hd), "normal", d),
            (("layers", "attn", "wo"), (n, h * hd, d), "normal", h * hd),
            (("layers", "moe", "router"), (n, d, e), "normal", d),
            (("layers", "moe", "wg"), (n, e, d, f), "normal", d),
            (("layers", "moe", "wi"), (n, e, d, f), "normal", d),
            (("layers", "moe", "wo"), (n, e, f, d), "normal", f),
            (("layers", "ffn_norm"), (n, d), "norm", 0),
        ]
    elif cfg["family"] == "ssm":
        di, st, r, k = cfg["intermediate_size"], cfg["state_size"], cfg["time_step_rank"], cfg["conv_kernel"]
        out += [
            (("layers", "mamba", "in_proj"), (n, d, 2 * di), "normal", d),
            (("layers", "mamba", "conv_w"), (n, di, k), "normal", k),
            (("layers", "mamba", "x_proj"), (n, di, r + 2 * st), "normal", di),
            (("layers", "mamba", "dt_proj"), (n, r, di), "normal", r),
            (("layers", "mamba", "dt_bias"), (n, di), "dt_bias", 0),
            (("layers", "mamba", "A_log"), (n, di, st), "a_log", 0),
            (("layers", "mamba", "D"), (n, di), "ones", 0),
            (("layers", "mamba", "out_proj"), (n, di, d), "normal", di),
        ]
    else:
        raise ValueError(f"no layout for family {cfg['family']!r}")
    return out


def _seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) % (1 << 63)


def _draw(rule: str, shape, fan_in: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if rule == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev).mul_(1.0 / math.sqrt(fan_in))
    if rule == "norm":
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev).mul_(0.1)
    if rule == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if rule == "a_log":
        st = shape[-1]
        a = torch.log(torch.arange(1, st + 1, dtype=torch.float32, device=dev))
        return a.expand(shape).to(dtype).contiguous()
    if rule == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)  # softplus^-1(dt)
    raise ValueError(rule)


def serve_dtype(shape, compute: torch.dtype) -> torch.dtype:
    """The type a leaf is served in: the compute type for rank > 1, float32
    for vectors (the port rounds float32 leaves of rank > 1 at each step)."""
    return compute if len(shape) > 1 else torch.float32


def leaf(cfg: Dict, seed: int, index: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Leaf ``index`` of :func:`layout`, drawn in ``dtype`` on ``device``."""
    _, shape, rule, fan_in = layout(cfg)[index]
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, index))
    return _draw(rule, shape, fan_in, dtype, gen)


def make(cfg: Dict, seed: int, device, masters: bool = False, compute: torch.dtype = torch.bfloat16) -> Dict:
    """The whole tree: each leaf in the type it is served in, or float32
    throughout with ``masters`` (a training state's masters)."""
    tree: Dict = {}
    for i, (path, shape, _, _) in enumerate(layout(cfg)):
        dtype = torch.float32 if masters else serve_dtype(shape, compute)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(cfg, seed, i, dtype, device)
    return tree


def leaves(tree: Dict) -> List[torch.Tensor]:
    return [v for x in tree.values() for v in (leaves(x) if isinstance(x, dict) else [x])]
