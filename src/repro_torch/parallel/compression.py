"""Gradient compression with error feedback, leaf by leaf.

The port's copy of the reference's ``repro/parallel/compression.py``.  Two
compressors, applied to each leaf before the gradient reduction, with the
residual kept locally (error feedback) so the compression is unbiased over
time:

* ``topk``: keep the entries with ``|g| >=`` the threshold of the top
  ``frac`` fraction, zero the rest, and add the zeroed part to an error
  buffer that is put back into the next step's gradient.  A leaf of at most
  65,536 elements takes its threshold from the merge-path top-k
  (:func:`repro_torch.core.topk_desc`, plain tensors, as the reference's
  ``repro.core``); a larger one from the linear-interpolated ``1 - frac``
  quantile of ``|g|``, computed bit for bit as ``jnp.quantile`` on the CPU
  computes it (:func:`quantile_threshold`; ROADMAP.md, R12).
* ``int8``: symmetric int8 quantization per leaf (scale ``max|g| / 127``,
  which XLA computes as ``max|g| * float32(1 / 127)``), the residual fed
  back too.

Error states are float32 trees in the gradients' layout
(:func:`init_error_state`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import topk_desc

TOPK_CORE_MAX = 65536  # leaves up to this size take the merge-path top-k


def _tree_map(fn, *trees):
    first = trees[0]
    return {k: _tree_map(fn, *(t[k] for t in trees)) if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in first.items()}


def init_error_state(params: Dict) -> Dict:
    """Float32 zeros of each leaf's shape, on its device."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _round_to_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``float32(a + b)`` rounded once from the exact sum of two float64
    scalars: the float64 sum rounded to odd (TwoSum's error picks the odd
    neighbour), then to nearest float32, which is exact since float64 has
    more than 24 + 2 bits."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    toward = torch.nextafter(s, torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, -float("inf"))))
    odd = (s.view(torch.int64) & 1) == 1
    return torch.where((err == 0) | odd, s, toward).float()


def _order_stats(a: torch.Tensor, low: int, high: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s[low], s[high])`` of ``s = sort(a)``, ``high`` being ``low`` or
    ``low + 1``, exactly: one sort on the card (a radix sort), one
    quickselect and two passes on the CPU (a sort of the largest leaves
    there takes seconds)."""
    if a.is_cuda:
        s = torch.sort(a).values
        return s[low], s[high]
    low_v = torch.kthvalue(a, low + 1).values
    if high == low:
        return low_v, low_v
    # s[low + 1] is low_v again if more than low + 1 elements are <= low_v, else the least larger element
    above = torch.where(a > low_v, a, torch.full_like(a, float("inf"))).min()
    return low_v, torch.where((a <= low_v).sum() > high, low_v, above)


def quantile_threshold(a: torch.Tensor, frac: float) -> torch.Tensor:
    """``jnp.quantile(a, 1 - frac)`` (linear method) of a 1-D float32
    tensor, bit for bit as XLA computes it on the CPU.

    jax's ``_quantile`` works in float32: ``q = float32(1 - frac) *
    (float32(n) - 1)``, ``low = floor(q)`` and ``high = ceil(q)`` clamped to
    ``[0, n - 1]``, ``hw = q - low``, ``lw = 1 - hw``, and the result ``low_v
    * lw + high_v * hw``, which XLA contracts into ``fma(high_v, hw,
    float32(low_v * lw))``.  The order statistics are exact
    (:func:`_order_stats`), never ``torch.quantile``, which refuses inputs
    past 2^24 elements.  A NaN anywhere gives NaN, as there."""
    n = a.numel()
    f32 = np.float32
    nf = f32(n)
    q = f32(f32(1.0 - frac) * f32(nf - f32(1)))
    low_f, high_f = np.floor(q), np.ceil(q)
    hw = f32(q - low_f)
    lw = f32(f32(1) - hw)
    top = f32(nf - f32(1))
    low = min(int(min(max(low_f, f32(0)), top)), n - 1)
    high = min(int(min(max(high_f, f32(0)), top)), n - 1)
    low_v, high_v = _order_stats(a, low, high)
    low_part = (low_v.double() * float(lw)).float().double()  # float32(low_v * lw): the product is exact in float64
    thresh = _round_to_float32(high_v.double() * float(hw), low_part)
    return torch.where(torch.isnan(a).any(), torch.full_like(thresh, float("nan")), thresh)


def _topk_leaf(g: torch.Tensor, err: torch.Tensor, frac: float) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float() + err
    flat = g.reshape(-1)
    n = flat.shape[0]
    k = max(1, int(frac * n))
    if n <= TOPK_CORE_MAX:
        vals, _ = topk_desc(flat.abs(), k)
        thresh = vals[-1]
    else:
        thresh = quantile_threshold(flat.abs(), frac)
    kept = torch.where(flat.abs() >= thresh, flat, 0.0)  # XLA makes the reference's `flat * mask` this select
    return kept.reshape(g.shape), (flat - kept).reshape(g.shape)


def _int8_leaf(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float() + err
    # XLA turns the reference's `/ 127.0` into a product with float32(1 / 127)
    scale = torch.clamp(g.abs().max(), min=1e-12) * torch.tensor(1 / 127, dtype=torch.float32, device=g.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)  # round half to even, as jnp.round
    deq = q.float() * scale
    # and contracts its `g - deq` into fma(-q, scale, g): one rounding of the exact value, which float64 holds
    # (|g - q * scale| <= 128 scale, both terms multiples of 2^-24 scale or of g's last bit)
    return deq, (g.double() - q.double() * scale.double()).float()


def compress_grads(grads: Dict, err_state: Dict, method: str, topk_frac: float) -> Tuple[Dict, Dict]:
    """``(compressed_grads, new_error_state)`` of a gradient tree and its
    error state (float32, the gradients' layout); ``method`` is ``"none"``
    (both returned as they are), ``"topk"`` (keep ``topk_frac`` of each
    leaf) or ``"int8"``."""
    if method == "none":
        return grads, err_state
    if method == "topk":
        out = _tree_map(lambda g, e: _topk_leaf(g, e, topk_frac), grads, err_state)
    elif method == "int8":
        out = _tree_map(_int8_leaf, grads, err_state)
    else:
        raise ValueError(f"unknown grad_compression {method!r}; known: none, topk, int8")
    return _tree_map(lambda o: o[0], out), _tree_map(lambda o: o[1], out)
