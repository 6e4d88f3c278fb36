"""The plain reference of a training step: the loss, its gradients, and AdamW.

The loss is the mean token cross-entropy over the labels that are not
masked (``label < 0`` is masked) plus ``z_loss`` times the mean squared
log-partition; the optimizer clips the gradients to a global norm, takes
the learning rate of a linear warm-up followed by a cosine down to a tenth,
and applies AdamW with decoupled weight decay, bias-corrected, every leaf
in float32.  The run's settings (``TrainSettings``) come from the cell's
file.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from . import model


def loss_fn(logits: torch.Tensor, labels: torch.Tensor, z_loss: float) -> torch.Tensor:
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    return ((lse - gold) * mask).sum() / denom + z_loss * (lse * lse * mask).sum() / denom


def learning_rate(s: Dict, step: int) -> float:
    warm = min(step / max(1, s["warmup_steps"]), 1.0)
    prog = min(max((step - s["warmup_steps"]) / max(1, s["total_steps"] - s["warmup_steps"]), 0.0), 1.0)
    return s["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


class Trainer:
    """Float32 masters ``params`` (leaves that require gradients) with
    AdamW's moments, stepped by :meth:`step`."""

    def __init__(self, cfg: Dict, settings: Dict, params: Dict, quant: Optional[str] = None):
        self.cfg, self.s, self.params, self.quant = cfg, settings, params, quant
        self.leaves: List[torch.Tensor] = [p.requires_grad_() for p in _leaves(params)]
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = 0

    def step(self, tokens: torch.Tensor, labels: torch.Tensor) -> Tuple[float, List[torch.Tensor]]:
        """One step: ``(loss, the clipped gradients as the moments took them)``."""
        s = self.s
        logits = model.train_logits(self.cfg, self.params, tokens, self.quant)
        loss = loss_fn(logits, labels, s["z_loss"])
        del logits
        grads = torch.autograd.grad(loss, self.leaves)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(s["grad_clip"] / torch.clamp(norm, min=1e-9), max=1.0)
        for g in grads:
            g.mul_(scale)
        lr = learning_rate(s, self.t)
        b1, b2 = s["beta1"], s["beta2"]
        bc1, bc2 = 1.0 - b1 ** (self.t + 1), 1.0 - b2 ** (self.t + 1)
        with torch.no_grad():
            for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                p.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + s["eps"]) + s["weight_decay"] * p))
        self.t += 1
        return float(loss.detach()), grads


def _leaves(tree: Dict) -> List[torch.Tensor]:
    return [v for x in tree.values() for v in (_leaves(x) if isinstance(x, dict) else [x])]
