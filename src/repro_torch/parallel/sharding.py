"""Sharding rules: logical activation and parameter axes to mesh dimensions,
on ``torch.distributed``'s ``DeviceMesh`` and DTensor.

The port's copy of the reference's ``repro/parallel/sharding.py``.  The
layout:

* batch   -> (pod, data)   (pod only on the multi-pod mesh)
* FSDP    -> data          (or (pod, data) when ``cfg.fsdp_over_pod``:
                            nemotron-4-340b's optimizer state needs it)
* tensor  -> model         (heads, ff, vocab, experts, d_inner)
* context -> model         (the decode cache's sequence dimension for
                            long-context decode)

A spec keeps the reference's ``PartitionSpec`` shape: a tuple with one
entry per tensor dimension, each ``None``, a mesh dimension's name or a
tuple of names, so ``tuple(P)`` of the reference's compares with it
directly.  :func:`placements` turns a spec into DTensor placements, one per
mesh dimension: ``Shard(d)`` on each mesh dimension that names tensor
dimension ``d``, else ``Replicate()``; an entry ``("pod", "data")`` shards
``d`` over both, pod-major, as JAX orders it.

The model calls :func:`constrain` where the reference constrains its
activations (13 calls there).  It returns its input untouched unless a
:func:`sharding_env` is active and the input is a DTensor, which it then
redistributes to the rules' layout: the model code runs the same with no
mesh at all.  One site differs: the attention's q, k and v are laid out
before their split into heads, all three replicated over the tensor axis
(the reference shards q's heads), because a DTensor sharded over the heads
cannot split them into (kv heads, group) where the tensor axis does not
divide them evenly, and torch 2.11's DTensor cannot merge a sharded
dimension into an outer one, as the attention's einsums do.  The attention
core is so replicated over the tensor axis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import is_dtensor

Spec = Tuple  # one entry per tensor dimension: None, a mesh dimension's name or a tuple of names


def canon_entry(mesh_axes):
    """A spec entry: () -> None, ("x",) -> "x", longer tuples as they are."""
    if not mesh_axes:
        return None
    if isinstance(mesh_axes, tuple) and len(mesh_axes) == 1:
        return mesh_axes[0]
    return mesh_axes


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical axis -> mesh dimensions."""

    batch: Tuple[str, ...] = ("data",)
    fsdp: Tuple[str, ...] = ("data",)
    tensor: Tuple[str, ...] = ("model",)
    context: Tuple[str, ...] = ()  # ("model",) for context-parallel decode

    def spec(self, *logical: Optional[str]) -> Spec:
        return tuple(None if ax is None else canon_entry(getattr(self, ax)) for ax in logical)


# the logical names the model code uses for activations
_ACT_AXIS = {
    "act_batch": "batch",
    "act_seq": None,
    "act_kv_seq": "context",
    "act_heads": "tensor",
    "act_ff": "tensor",
    "act_vocab": "tensor",
    "act_embed": None,
    "act_experts": "tensor",
    "none": None,
}


@dataclasses.dataclass
class ShardingEnv:
    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    rules: MeshRules


_STATE = threading.local()


def current_env() -> Optional[ShardingEnv]:
    return getattr(_STATE, "env", None)


@functools.cache
def register_rules() -> None:
    """Give DTensor the sharding rules the port's operations need and it
    lacks.  One so far: ``aten.searchsorted.Tensor`` (the MoE dispatch's
    expert offsets, ``core.batched.searchsorted_batched``): sorted rows and
    queries sharded alike on a leading (batch) dimension give insertion
    points sharded the same way; any other layout is replicated first.

    Called by :func:`sharding_env` and :func:`put_tree`, where a run starts
    to use DTensors, and not at import: importing the DTensor package costs
    about a second, which a process that never shards should not pay."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, queries, *args, **kwargs):
        rest = [None] * len(args)
        out = [([Replicate()], [Replicate(), Replicate()] + rest)]
        for d in range(min(sorted_sequence.ndim, queries.ndim) - 1):
            out.append(([Shard(d)], [Shard(d), Shard(d)] + rest))
        return out


@contextlib.contextmanager
def sharding_env(mesh, rules: MeshRules):
    """Make ``(mesh, rules)`` the layout :func:`constrain` enforces in this
    thread, for the ``with`` block."""
    register_rules()
    prev = current_env()
    _STATE.env = ShardingEnv(mesh, rules)
    try:
        yield _STATE.env
    finally:
        _STATE.env = prev


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements, one per mesh dimension, of ``spec`` on ``mesh``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's order {names}: DTensor shards major to "
                             "minor along the mesh")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)


def constrain(x: torch.Tensor, *act_axes: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to the layout of its logical activation axes
    under the active :func:`sharding_env`; ``x`` itself with no env or when
    ``x`` is a plain tensor."""
    env = current_env()
    if env is None or not is_dtensor(x):
        return x
    spec = env.rules.spec(*(_ACT_AXIS.get(a) if a is not None else None for a in act_axes))
    want = placements(spec, env.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(env.mesh, want)


def _dense_shard(x):
    """``x`` with a dense layout, globally and in its local shard: a copy
    where either is strided.  ``DTensor.contiguous`` judges the global
    layout only, which can be dense while the shard is not, and a product
    views the shard by the global strides, so both are looked at."""
    if is_dtensor(x) and not (x.is_contiguous() and x._local_tensor.is_contiguous()):
        return x.clone(memory_format=torch.contiguous_format)
    return x


class _Contiguous(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _dense_shard(x)

    @staticmethod
    def backward(ctx, g):
        return _dense_shard(g)


def contiguous_shards(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a contiguous local shard, and its gradient too, when ``x``
    is a DTensor; ``x`` itself otherwise.

    A redistribution between two shardings (an all-to-all) can leave the
    local shard strided.  An einsum then permutes and views its operand,
    and the local view of a strided shard raises ("view size is not
    compatible with input tensor's size and stride").  The gradient meets
    the same when it flows back through the redistribution, so both
    directions are made contiguous here, where the product takes its
    operand."""
    return _Contiguous.apply(x) if is_dtensor(x) else x


def write_token_sharded(cache, slot, new) -> None:
    """``cache[r, slot[r]] = new[r]`` for every batch row ``r``, in place in
    the local shard of a DTensor ``cache`` ``(B, S, ...)`` (the decode
    cache, sharded on batch and kv-seq).

    DTensor has no rule for an ``index_put_`` into a dimension sharded over
    the context axis.  So each device writes its local shard itself: the
    rows of ``slot`` ``(B,)`` and ``new`` ``(B, ...)`` (DTensors, or plain
    tensors that every device holds whole) that its shard holds, each slot
    shifted by the shard's offset on the kv-seq dimension.  A row whose
    slot lies in another device's shard writes back the value it holds at
    the clamped slot, so nothing changes there and no branch depends on the
    data (the dry run's meta tensors have none).  The write is one
    ``index_put_`` on the local tensor, which a dispatch mode around the
    call sees and counts."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    local = cache.to_local()

    def rows(t, dims):
        """``t``'s local block under the cache's sharding of ``dims`` (cache
        dimension per dimension of ``t``), replicated elsewhere."""
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want = [Shard(dims.index(p.dim)) if isinstance(p, Shard) and p.dim in dims else Replicate()
                for p in cache.placements]
        return t.redistribute(mesh, want).to_local()

    rows_slot = rows(slot, (0,))
    rows_new = rows(new, (0,) + tuple(range(2, cache.ndim))).to(local.dtype)
    s0, ns = offset[1], shape[1]
    held = ((rows_slot >= s0) & (rows_slot < s0 + ns)).reshape((-1,) + (1,) * (rows_new.ndim - 1))
    idx = torch.clamp(rows_slot - s0, 0, max(ns - 1, 0))
    ridx = torch.arange(local.shape[0], device=local.device)
    local[ridx, idx] = torch.where(held, rows_new, local[ridx, idx])


def make_rules(mesh, fsdp_over_pod: bool = False, context_parallel: bool = False) -> MeshRules:
    """The rules for ``mesh`` (a ``DeviceMesh`` with dimensions ``(data,
    model)`` or ``(pod, data, model)``)."""
    multi_pod = "pod" in tuple(mesh.mesh_dim_names)
    batch = ("pod", "data") if multi_pod else ("data",)
    fsdp = ("pod", "data") if (multi_pod and fsdp_over_pod) else ("data",)
    return MeshRules(batch=batch, fsdp=fsdp, tensor=("model",), context=("model",) if context_parallel else ())


# ---------------------------------------------------------------------------
# Parameter sharding: leaf name -> logical axes of its trailing dimensions
# ---------------------------------------------------------------------------

# leading stacked-layer dimensions get None
_PARAM_RULES = {
    # embeddings
    "table": ("tensor", "fsdp"),  # (V, d)
    "unembed": ("fsdp", "tensor"),  # (d, V)
    "prefix_proj": ("fsdp", None),  # (d_in, d)
    "pos_embed": (None, "fsdp"),  # (S, d)
    # attention
    "wq": ("fsdp", "tensor"),
    "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"),
    "wo": ("tensor", "fsdp"),
    "xq": ("fsdp", "tensor"),
    "xk": ("fsdp", "tensor"),
    "xv": ("fsdp", "tensor"),
    "xo": ("tensor", "fsdp"),
    # dense mlp
    "wi": ("fsdp", "tensor"),
    "wg": ("fsdp", "tensor"),
    # moe (leaves under "moe" take the expert-leading rules below)
    "router": ("fsdp", None),  # (d, E)
    # mamba
    "in_proj": ("fsdp", "tensor"),  # (d, 2*di)
    "conv_w": ("tensor", None),  # (di, k)
    "x_proj": ("tensor", None),  # (di, r+2s)
    "dt_proj": (None, "tensor"),  # (r, di)
    "dt_bias": ("tensor",),  # (di,)
    "A_log": ("tensor", None),  # (di, s)
    "D": ("tensor",),  # (di,)
    "out_proj": ("tensor", "fsdp"),  # (di, d)
}

_MOE_RULES = {
    # (E, d, ff_e) / (E, ff_e, d): experts over tensor, d over fsdp
    "wi": ("tensor", "fsdp", None),
    "wg": ("tensor", "fsdp", None),
    "wo": ("tensor", None, "fsdp"),
    "router": ("fsdp", None),
}

_NORM_NAMES = ("scale", "attn_norm", "ffn_norm", "cross_norm", "final_norm", "norm")


def param_spec(path: Tuple[str, ...], leaf) -> Tuple[Tuple[Optional[str], ...], str]:
    """``(logical axes, name)`` of one parameter leaf at dict path ``path``:
    one logical axis (or None) per dimension of ``leaf``."""
    name = path[-1]
    in_moe = "moe" in path and "shared" not in path
    logical = (_MOE_RULES if in_moe else _PARAM_RULES).get(name)
    if logical is None:
        logical = (None,) if name in _NORM_NAMES else ()
    pad = leaf.ndim - len(logical)
    if pad < 0:  # a leaf smaller than its rule: replicated
        return (None,) * leaf.ndim, name
    return tuple([None] * pad + list(logical)), name


def _map_with_path(fn, tree, path=()):
    return {k: _map_with_path(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


def _map(fn, *trees):
    return {k: _map(fn, *(t[k] for t in trees)) if isinstance(v, dict) else fn(*(t[k] for t in trees))
            for k, v in trees[0].items()}


def param_pspec_tree(params: Dict, rules: MeshRules) -> Dict:
    """The spec of every leaf of ``params``, in its layout."""

    def one(path, leaf):
        logical, _ = param_spec(path, leaf)
        return tuple(None if ax is None else canon_entry(getattr(rules, ax)) for ax in logical)

    return _map_with_path(one, params)


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def sanitize_spec(spec: Spec, shape, mesh) -> Spec:
    """``spec`` without the sharding of any dimension that its mesh degree
    does not divide (the reference's jit shardings need exact division:
    hymba's vocab 32001 and whisper's 51866 cannot shard 16 ways, so they
    stay replicated)."""
    sizes = _mesh_sizes(mesh)
    out = []
    for i, entry in enumerate(tuple(spec)):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        deg = math.prod(sizes[a] for a in axes)
        out.append(entry if shape[i] % deg == 0 else None)
    return tuple(out)


class NamedSharding(NamedTuple):
    """The reference's ``NamedSharding``: a mesh and the DTensor placements
    of one leaf on it (``spec`` the spec they come from)."""

    mesh: object
    placements: tuple
    spec: Spec


def named_sharding(mesh, spec: Spec) -> NamedSharding:
    return NamedSharding(mesh, placements(spec, mesh), tuple(spec))


def sanitized_sharding_tree(tree: Dict, spec_tree: Dict, mesh) -> Dict:
    """A :class:`NamedSharding` per leaf of ``tree`` (tensors or meta
    tensors) from the spec tree, each sanitized against its leaf's shape."""
    return _map(lambda leaf, s: named_sharding(mesh, sanitize_spec(s, leaf.shape, mesh)), tree, spec_tree)


def param_sharding_tree(params: Dict, mesh, rules: MeshRules) -> Dict:
    return sanitized_sharding_tree(params, param_pspec_tree(params, rules), mesh)


def put_tree(tree, shardings):
    """``tree`` (a dict tree of tensors, or one tensor) distributed leaf by
    leaf by its ``(mesh, placements)`` (a :class:`NamedSharding` or a pair)
    in ``shardings``: the counterpart of ``jax.device_put`` with a
    ``NamedSharding`` tree.  A meta leaf gives a meta DTensor (nothing
    allocated)."""
    if isinstance(tree, dict):
        return {k: put_tree(v, shardings[k]) for k, v in tree.items()}
    from torch.distributed.tensor import distribute_tensor

    register_rules()

    return distribute_tensor(tree, shardings[0], shardings[1])


def distribute_tree(tree: Dict, spec_tree: Dict, mesh) -> Dict:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` with its spec,
    sanitized against the leaf's shape."""
    return put_tree(tree, sanitized_sharding_tree(tree, spec_tree, mesh))
