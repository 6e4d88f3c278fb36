"""Token samplers on the merge-path top-k.

The PyTorch counterpart of the reference's ``repro/serving/sampler.py``
for unmasked vocab rows.  ``topk_sample`` takes the per-row top-k
candidates from one of two backends, which return bit-identical
candidates:

* ``"core"`` — the pure-PyTorch batched kv-sort (``repro_torch.core``);
* ``"kernel"`` — the flat sort rounds of ``repro_torch.kernels.ops``, whose
  wide rounds launch the K4 kernel on a CUDA tensor (the counterpart of
  the reference's ``backend="pallas"``).

The draw is Gumbel-max on an explicit ``torch.Generator``:
``argmax(log p + G)`` with ``G = -log(-log U)`` samples index ``i`` with
probability ``p_i``.  It does not reproduce the reference's threefry bits;
it follows the same distribution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import topk_batched
from repro_torch.kernels import ops as kops

BACKENDS = ("core", "kernel")


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _topk_candidates(
    logits: torch.Tensor, k: int, backend: str, tile: Optional[int], leaf: Optional[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    if backend == "kernel":
        return kops.topk_batched(logits, k, tile=tile, leaf=leaf)
    if backend == "core":
        return topk_batched(logits, k)
    raise ValueError(f"unknown sampler backend {backend!r}; expected one of {BACKENDS}")


def topk_sample(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,  # on logits' device
    k: int = 40,
    temperature: float = 1.0,
    backend: str = "core",
    tile: Optional[int] = None,  # kernel tile override (None = tune.pick)
    leaf: Optional[int] = None,  # kernel leaf override (None = tune.pick)
) -> torch.Tensor:
    """One token per row from the softmax over its top-k candidates: ``(B,)`` int32."""
    vals, idx = _topk_candidates(logits, k, backend, tile, leaf)
    probs = torch.softmax(vals.float() / max(temperature, 1e-6), dim=-1)
    loglik = torch.log(torch.clamp(probs, min=1e-30))
    u = torch.rand(loglik.shape, generator=generator, device=loglik.device)
    choice = torch.argmax(loglik - torch.log(-torch.log(u)), dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
