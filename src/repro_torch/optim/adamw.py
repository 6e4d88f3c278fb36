"""AdamW with a cosine schedule and a global-norm clip.

The counterpart of the reference's ``repro/optim/adamw.py``, leaf for leaf:
the same schedule, clip, update order and bias correction, in float32.
Parameters are float32 masters (the model casts them at use) and the
moments ``m`` and ``v`` float32, in nested dicts of the parameters'
layout.  No ``torch.optim`` class: the reference's arithmetic is the
contract.

One difference of form: :func:`clip_by_global_norm` and
:func:`adamw_update` update the gradients, parameters and moments in
place and return them, where the reference builds new trees.  At the
full width of falcon-mamba-7b a second copy of the masters and moments
would not fit beside the first; the reference's launcher donates the old
state, so nothing there sees the old values either.  Gradient
compression, when the train step has it, runs before :func:`adamw_update`
(:mod:`repro_torch.parallel.compression`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import TrainConfig


def tree_leaves(tree) -> Iterator[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


def _zeros_like(tree) -> Dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in tree.items()}


def cosine_schedule(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup, then a
    cosine from ``learning_rate`` down to a tenth of it."""
    step = step.float()
    warm = torch.clamp(step / max(1, tcfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps) / max(1, tcfg.total_steps - tcfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def init_opt_state(params: Dict) -> Dict:
    """``{"m", "v"}``: float32 zeros in the parameters' layout."""
    return {"m": _zeros_like(params), "v": _zeros_like(params)}


def global_norm(tree: Dict) -> torch.Tensor:
    """The float32 L2 norm over every leaf."""
    sq = sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads: Dict, max_norm: float) -> Tuple[Dict, torch.Tensor]:
    """Scale the float32 gradients, in place, so that their global norm is
    at most ``max_norm``; returns ``(grads, norm before the clip)``."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        if g.dtype != torch.float32:
            raise TypeError(f"clip_by_global_norm: gradients are float32, got {g.dtype}")
        g.mul_(scale)
    return grads, norm


def adamw_update(tcfg: TrainConfig, params: Dict, grads: Dict, opt_state: Dict, step: torch.Tensor):
    """One AdamW step, in place.  Returns ``(params, opt_state, metrics)``
    with ``metrics = {"grad_norm", "lr"}`` (the norm before the clip)."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    lr = cosine_schedule(tcfg, step)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    t = (step + 1).float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        if p.shape != g.shape or p.shape != m.shape or p.shape != v.shape:
            raise ValueError(f"adamw_update: shapes differ: {tuple(p.shape)}, {tuple(g.shape)}, "
                             f"{tuple(m.shape)}, {tuple(v.shape)}")
        m.mul_(b1).add_(g * (1 - b1))  # b1 * m + (1 - b1) * g
        v.mul_(b2).add_(g * (1 - b2) * g)  # b2 * v + (1 - b2) * g * g
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))  # mh / (sqrt(vh) + eps)
        upd.add_(p.float() * wd).mul_(lr)  # lr * (... + wd * p)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:  # in float32, then rounded once, as the reference does
            p.copy_(p.float() - upd)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
