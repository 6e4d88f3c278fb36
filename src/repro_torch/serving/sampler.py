"""Token samplers on the merge-path top-k.

The PyTorch counterpart of the reference's ``repro/serving/sampler.py``.
``topk_sample`` and ``topp_sample`` take the per-row top-k candidates
from one of three backends, which return bit-identical candidates:

* ``"core"`` — the pure-PyTorch batched kv-sort (``repro_torch.core``);
* ``"kernel"`` — the flat sort rounds of ``repro_torch.kernels.ops``, whose
  wide rounds launch the K4 kernel on a CUDA tensor (the counterpart of
  the reference's ``backend="pallas"``);
* ``"distributed"`` — the vocab sharded over a process group (``group=``,
  ``None`` for the world): each rank passes its ``(B, V_i)`` slice of the
  logits, in the ceil-div partition, and
  :func:`repro_torch.core.distributed.distributed_topk_batched` gives every
  rank the same global candidates.  The ranks draw the same token only
  when every rank's ``generator`` is seeded alike.  ``vocab_lens`` is not
  taken there: pad the sharded vocab with ``-inf`` logits instead.

**Masked vocab** (``vocab_lens``): only a prefix of each logit row is
real.  The candidates then come from the ragged top-k
(``topk_batched_ragged``): the valid length bounds the sort itself, and
masked slots return index ``-1``.  They get a ``-inf`` log-likelihood, so
a masked slot is never drawn while a valid candidate exists; a row with
``vocab_lens[r] == 0`` returns ``-1``, which callers must treat as "no
token".

The draw is Gumbel-max on an explicit ``torch.Generator``:
``argmax(log p + G)`` with ``G = -log(-log U)`` samples index ``i`` with
probability ``p_i``.  It does not reproduce the reference's threefry bits;
it follows the same distribution.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import min_sentinel, topk_batched, topk_batched_ragged
from repro_torch.core.distributed import distributed_topk_batched
from repro_torch.kernels import ops as kops

BACKENDS = ("core", "kernel", "distributed")


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _topk_candidates(
    logits: torch.Tensor, k: int, vocab_lens, backend: str, tile: Optional[int], leaf: Optional[int], group=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    if backend == "distributed":
        if vocab_lens is not None:
            raise ValueError(
                "vocab_lens is not supported with backend='distributed' — pad "
                "the sharded vocab with -inf ban logits instead"
            )
        return distributed_topk_batched(logits, k, group=group)
    if backend == "kernel":
        if vocab_lens is None:
            return kops.topk_batched(logits, k, tile=tile, leaf=leaf)
        return kops.topk_batched_ragged(logits, k, vocab_lens, tile=tile, leaf=leaf)
    if backend == "core":
        return topk_batched(logits, k) if vocab_lens is None else topk_batched_ragged(logits, k, vocab_lens)
    raise ValueError(f"unknown sampler backend {backend!r}; expected one of {BACKENDS}")


def _draw(probs: torch.Tensor, idx: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One candidate per row by Gumbel-max over ``log probs``; masked slots
    (index ``-1``) get ``-inf`` and are never drawn while a valid one exists."""
    loglik = torch.log(torch.clamp(probs, min=1e-30))
    loglik = torch.where(idx >= 0, loglik, min_sentinel(loglik.dtype))
    u = torch.rand(loglik.shape, generator=generator, device=loglik.device)
    choice = torch.argmax(loglik - torch.log(-torch.log(u)), dim=-1)
    return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)


def topk_sample(
    logits: torch.Tensor,  # (B, V)
    generator: torch.Generator,  # on logits' device
    k: int = 40,
    temperature: float = 1.0,
    vocab_lens=None,  # optional (B,) or scalar: the valid vocab prefix of each row
    backend: str = "core",  # "core" | "kernel" | "distributed" (vocab-sharded)
    tile: Optional[int] = None,  # kernel tile override (None = tune.pick)
    leaf: Optional[int] = None,  # kernel leaf override (None = tune.pick)
    group=None,  # backend="distributed": the process group that shards the vocab
) -> torch.Tensor:
    """One token per row from the softmax over its top-k candidates: ``(B,)`` int32."""
    vals, idx = _topk_candidates(logits, k, vocab_lens, backend, tile, leaf, group)
    probs = torch.softmax(vals.float() / max(temperature, 1e-6), dim=-1)
    return _draw(probs, idx, generator)


def topp_sample(
    logits: torch.Tensor,
    generator: torch.Generator,
    p: float = 0.9,
    k_max: int = 128,
    temperature: float = 1.0,
    vocab_lens=None,
    backend: str = "core",
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
    group=None,
) -> torch.Tensor:
    """Nucleus sampling over the merge-path-sorted top-``k_max`` candidates:
    the smallest prefix whose probability reaches ``p`` (at least one)."""
    vals, idx = _topk_candidates(logits, k_max, vocab_lens, backend, tile, leaf, group)
    probs = torch.softmax(vals.float() / max(temperature, 1e-6), dim=-1)
    probs = torch.where(idx >= 0, probs, 0.0)
    keep = torch.cumsum(probs, dim=-1) - probs < p  # always keeps the first candidate
    return _draw(torch.where(keep, probs, 0.0), idx, generator)
