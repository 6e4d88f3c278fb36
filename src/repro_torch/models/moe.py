"""Mixture-of-Experts with merge-path sorted dispatch.

The PyTorch counterpart of the reference's ``repro/models/moe.py``.  Token
to expert routing is a stable key-value merge sort of the flat
``(expert_id, slot)`` assignments of each batch row; stability gives a
deterministic drop order, by token position, when an expert runs out of
capacity.

1. router logits in float32, softmax, the top ``k`` experts per token
   (ties to the lower expert id, as ``jax.lax.top_k``);
2. flat assignment keys ``expert_id`` with values ``slot = token * k + j``;
3. a stable key-value sort groups every row's assignments by expert,
   token order kept within each expert.  ``cfg.moe_dispatch``:
   ``"merge_path_pallas"`` sorts on the hand-written kernels
   (:func:`repro_torch.kernels.ops.sort_kv_batched`: the tile sort S1 and
   then the wide rounds of K4; their plain versions for a CPU tensor),
   ``"merge_path"`` on the plain batched sort of :mod:`repro_torch.core`
   (:func:`~repro_torch.core.merge_sort_kv_batched` and its ragged form),
   ``"cumsum"`` takes the one-hot cumsum positions instead (the ablation);
4. position in expert = sorted rank - the expert's first rank (a batched
   binary search over the sorted ids);
5. the tokens are scattered into ``(B, E, capacity, d)``, the experts run
   as three batched products, and each token sums its ``k`` weighted
   expert outputs in slot order.

Every route is differentiable: the sorts move integers only, and the
scatters and gathers of the float activations have exact transposes.
The reference's sharding constraints are left out (the port has no mesh
layer yet).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import max_sentinel, merge_sort_kv_batched, merge_sort_kv_batched_ragged, searchsorted_batched
from repro_torch.core.batched import _mask_rows, _scatter_rows
from repro_torch.parallel.sharding import constrain, contiguous_shards

from .layers import dense_init, mlp_init
from .layers import profiler_range as _range

DISPATCH_MODES = ("merge_path", "merge_path_pallas", "cumsum")
_MASKED = 2 ** 30  # the position a masked slot reports: past any capacity




def _stacked_init(gen: torch.Generator, shape, fan_in: int, dtype: torch.dtype, lead=()) -> torch.Tensor:
    """:func:`~repro_torch.models.layers.dense_init` of ``lead + shape``, drawn
    one ``shape`` at a time into a stack in ``dtype``: a float32 draw of the
    whole stack would not fit beside the others (moonshot-v1-16b-a3b's
    three expert stacks are 17.7 GB each in bfloat16)."""
    lead = tuple(lead)
    if not lead:
        return dense_init(gen, shape, fan_in, dtype)
    out = torch.empty(lead + tuple(shape), dtype=dtype, device=gen.device)
    for i in range(math.prod(lead)):
        out.view(-1, *shape)[i] = dense_init(gen, shape, fan_in, dtype)
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype, lead=()) -> Dict:
    """The router (float32, as in the reference), the experts' ``wg``, ``wi``
    ``(E, d, f)`` and ``wo`` ``(E, f, d)`` in ``dtype`` and the shared expert's
    MLP; ``lead`` prepends stacking axes (``(num_layers,)``)."""
    d, e, fe = cfg.d_model, cfg.num_experts, cfg.d_ff
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (d, e), d, torch.float32),
        "wg": _stacked_init(gen, (e, d, fe), d, dtype, lead),
        "wi": _stacked_init(gen, (e, d, fe), d, dtype, lead),
        "wo": _stacked_init(gen, (e, fe, d), fe, dtype, lead),
    }
    if cfg.shared_expert_ff:
        p["shared"] = mlp_init(gen, d, cfg.shared_expert_ff, "silu", dtype, lead)
    return p


def capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    """Slots per expert and batch row: ``tokens * k * capacity_factor / E``,
    at least 8 and a multiple of 8."""
    c = int(math.ceil(tokens_per_row * cfg.experts_per_token * cfg.capacity_factor / cfg.num_experts))
    return max(8, -(-c // 8) * 8)


def _positions_merge_path_batched(
    flat_expert: torch.Tensor,
    e: int,
    slot_lens: Optional[torch.Tensor] = None,
    backend: str = "core",
) -> torch.Tensor:
    """Position in expert of every slot of ``(B, N)`` int32 expert ids, aligned
    with the input slots (int32).

    One batched stable key-value sort of ``(expert_id, slot)`` groups every
    row's slots by expert; an expert's first rank comes from a batched
    binary search over the sorted ids.  With ``slot_lens`` ``(B,)`` only the
    first ``slot_lens[r]`` slots of row ``r`` are routed: the others sort
    after every real slot, take no capacity, and report position ``2^30``.

    ``backend="pallas"`` sorts with :func:`repro_torch.kernels.ops.sort_kv_batched`
    (S1, then K4's wide rounds; the masked slots' keys set to the sentinel
    first), ``"core"`` with :func:`~repro_torch.core.merge_sort_kv_batched` or
    :func:`~repro_torch.core.merge_sort_kv_batched_ragged`.
    """
    b, n = flat_expert.shape
    dev = flat_expert.device
    ranks = torch.arange(n, dtype=torch.int32, device=dev)
    slots = ranks.expand(b, n)
    if backend == "pallas":
        from repro_torch.kernels import ops as kops

        keys = flat_expert
        if slot_lens is not None:
            keys = _mask_rows(keys, slot_lens, max_sentinel(keys.dtype))
        with _range("moe.sort"):
            sorted_e, sorted_slot = kops.sort_kv_batched(keys, slots)
    elif slot_lens is None:
        sorted_e, sorted_slot = merge_sort_kv_batched(flat_expert, slots)
    else:
        sorted_e, sorted_slot = merge_sort_kv_batched_ragged(flat_expert, slots, slot_lens)
    experts = torch.arange(e, dtype=flat_expert.dtype, device=dev).expand(b, e)
    offsets = searchsorted_batched(sorted_e, experts, side="left")  # (B, E)
    pos_sorted = ranks[None, :] - torch.gather(offsets, 1, torch.clamp(sorted_e.long(), 0, e - 1)).to(torch.int32)
    if slot_lens is not None:
        pos_sorted = torch.where(ranks[None, :] < slot_lens[:, None], pos_sorted, _MASKED)
    # each row's sorted slots are a permutation: scatter the positions back to slot order
    return _scatter_rows(torch.zeros((b, n), dtype=torch.int32, device=dev), sorted_slot.long(), pos_sorted)


def _positions_merge_path(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """Single-row form of :func:`_positions_merge_path_batched`."""
    return _positions_merge_path_batched(flat_expert[None, :], e)[0]


def _positions_cumsum(flat_expert: torch.Tensor, e: int) -> torch.Tensor:
    """The ablation: one-hot cumsum position in expert along the last axis
    (``O(N * E)``), for ``(N,)`` or ``(B, N)`` expert ids."""
    idx = flat_expert.long()
    pos = torch.cumsum(F.one_hot(idx, e).to(torch.int32), dim=-2) - 1
    return torch.gather(pos, -1, idx[..., None])[..., 0].to(torch.int32)


def _silu(gate: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step by step, ``gate * (1 / (1 + exp(-gate)))``: in
    bfloat16 each step rounds, as the reference's does, where ``F.silu``
    rounds once (a bfloat16 layer would differ in the last bit)."""
    return gate * torch.reciprocal(1 + torch.exp(-gate))


def _swiglu(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The shared expert: :func:`~repro_torch.models.layers.mlp_apply` with :func:`_silu`."""
    return (_silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]


def _router_topk(probs: torch.Tensor, k: int):
    """The first ``k`` of a stable descending sort: ``jax.lax.top_k``'s order,
    the lower expert id first among equal probabilities (``torch.topk``
    promises no order among ties)."""
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[..., :k], top_e[..., :k]


def moe_apply(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    token_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x (B, S, d) -> (B, S, d)``.

    ``token_counts`` (optional, ``(B,)`` int) marks each row's valid token
    count, padding at the sequence tail: the dispatch is then ragged, the
    padding tokens take no capacity and get zero output, and every valid
    token the position it would have in an unpadded batch.

    The router runs in float32 whatever the dtype of ``params["router"]``
    (the serve and train steps round it to the compute dtype with every
    stacked float32 leaf).  Dropped slots are scattered into a spill row at
    ``capacity``, sliced off after, so no boolean mask syncs the host.  A
    token's ``k`` expert outputs are summed in slot order in the
    activation dtype, the rounding of the reference's scatter-add.
    """
    if cfg.moe_dispatch not in DISPATCH_MODES:
        raise ValueError(f"moe_dispatch must be one of {DISPATCH_MODES}, got {cfg.moe_dispatch!r}")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = capacity(cfg, s)
    dev = x.device
    with _range("moe.route"):
        router_logits = x.float() @ params["router"].float()  # (B, S, E)
        probs = torch.softmax(router_logits, dim=-1)
        top_p, top_e = _router_topk(probs, k)  # (B, S, k)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(b, s * k).to(torch.int32)
    slot_lens = None
    if token_counts is not None:
        # slots are token-major, so the valid slots are the prefix tokens * k
        slot_lens = torch.clamp(torch.as_tensor(token_counts, device=dev).to(torch.int32), 0, s) * k
    with _range("moe.positions"):
        if cfg.moe_dispatch == "cumsum":
            pos = _positions_cumsum(flat_e, e)
            if slot_lens is not None:
                slot_ids = torch.arange(s * k, dtype=torch.int32, device=dev)[None, :]
                pos = torch.where(slot_ids < slot_lens[:, None], pos, _MASKED)
        else:
            backend = "pallas" if cfg.moe_dispatch == "merge_path_pallas" else "core"
            pos = _positions_merge_path_batched(flat_e, e, slot_lens, backend)  # (B, S*k)
    kept = pos < cap
    rows = torch.arange(b, device=dev)[:, None]
    tok = torch.arange(s, device=dev).repeat_interleave(k)  # (S*k,)
    fe = flat_e.long()
    with _range("moe.dispatch"):
        # (B, E, cap + 1, d): the kept (expert, position) pairs are unique; every dropped slot lands on row `cap`
        buf = x.new_zeros((b, e, cap + 1, d)).index_put((rows, fe, torch.where(kept, pos, cap).long()), x[:, tok])
        buf = constrain(buf[:, :, :cap], "act_batch", "act_experts", None, None)
    with _range("moe.experts"):
        up = torch.einsum("becd,edf->becf", buf, params["wi"])
        gate = torch.einsum("becd,edf->becf", buf, params["wg"])
        h = contiguous_shards(constrain(_silu(gate) * up, "act_batch", "act_experts", None, None))
        out_buf = torch.einsum("becf,efd->becd", h, params["wo"])  # (B, E, cap, d)
    with _range("moe.combine"):
        vals = out_buf[rows, fe, torch.clamp(pos, max=cap - 1).long()].reshape(b, s, k, d)
        w = (top_p.to(vals.dtype) * kept.reshape(b, s, k)).unsqueeze(-1)
        y = torch.zeros((b, s, d), dtype=vals.dtype, device=dev)
        for j in range(k):  # slot order, in the activation dtype
            y = y + vals[:, :, j] * w[:, :, j]
    if "shared" in params:
        y = y + _swiglu(params["shared"], x)
    return y.to(x.dtype)


def aux_load_balance_loss(router_logits: torch.Tensor, top_e: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load-balance loss: ``E * sum(mean prob * mean assignment)``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    me = probs.reshape(-1, e).mean(0)
    ce = F.one_hot(top_e.reshape(-1).long(), e).float().mean(0)
    return e * torch.sum(me * ce)
