"""Step builders, the counterparts of the reference's ``repro/train/steps.py``.

``make_train_step(cfg, tcfg)`` returns ``(state, batch) -> (state,
metrics)``: the loss (:func:`cross_entropy_loss`), its gradient by
autograd (through K9 and K10 with ``ssm_backend="fused"``), optionally
accumulated over microbatches, optionally compressed with error feedback
(``tcfg.grad_compression``: :mod:`repro_torch.parallel.compression`), and
the AdamW update.  The state is the reference's: ``{"step", "params",
"opt": {"m", "v"}}`` with float32 masters and moments, and ``"err"``, the
compression's float32 error state, when ``grad_compression != "none"``
(:func:`init_train_state`).  ``make_prefill_step(cfg)``
and ``make_decode_step(cfg)`` return the serve steps that the reference's
dry run lowers for its ``prefill`` and ``decode`` shapes
(:func:`abstract_train_state` is the train state as meta tensors).  Every step
casts the parameters to the compute dtype first, with the reference's
rule (:func:`_cast`).  A leaf already in that dtype passes through
uncopied, so a caller that serves many steps casts its parameters once
with :func:`_cast` (as the serving engine does) and each step copies
nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import abstract_params, forward_decode, forward_prefill, forward_train, init_params
from repro_torch.models.transformer import _dtype
from repro_torch.optim.adamw import adamw_update, init_opt_state, tree_leaves
from repro_torch.parallel import compression


def _rebuild(tree, leaves) -> Dict:
    """``tree``'s layout with ``leaves`` (in ``tree_leaves`` order) in place of its own."""
    it = iter(leaves)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else next(it) for k, v in node.items()}

    return walk(tree)


def cross_entropy_loss(
    logits: torch.Tensor, labels: torch.Tensor, z_loss: float
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy in float32 plus the z-loss; labels < 0 are
    masked.  Returns ``(loss, {"ce", "z_loss"})``."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device)
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    # the difference before the last axis is dropped: on a vocab-sharded DTensor the gather is a masked partial
    # whose mask keeps the gather's shape
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[..., None])
    ce = (lse[..., None] - gold)[..., 0] * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = ce.sum() / denom
    zl = z_loss * torch.sum(torch.square(lse) * mask) / denom
    return loss + zl, {"ce": loss, "z_loss": zl}


def init_train_state(
    cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Any]:
    """``{"step": int32 0, "params": float32 masters, "opt": {"m", "v"}}``
    (and ``"err"``, zeros, with gradient compression) on ``device`` (the
    card by default), the parameters from :func:`init_params` at ``seed``."""
    return _train_state(tcfg, init_params(cfg, seed=seed, device=resolve_device(device)))


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    """:func:`init_train_state`'s tree as meta tensors: shapes and dtypes,
    nothing allocated (the dry run's train state)."""
    return _train_state(tcfg, abstract_params(cfg))


def _train_state(tcfg: TrainConfig, params: Dict) -> Dict[str, Any]:
    params = _rebuild(params, [p.float() for p in tree_leaves(params)])
    step = torch.zeros((), dtype=torch.int32, device=params["final_norm"].device)
    state = {"step": step, "params": params, "opt": init_opt_state(params)}
    if tcfg.grad_compression != "none":
        state["err"] = compression.init_error_state(params)
    return state


def _cast(params: Dict, dtype: torch.dtype) -> Dict:
    """Float32 leaves of rank > 1 to ``dtype``; the others as they are.

    This is the reference's rule.  Once the layers are stacked, the
    Mamba blocks' ``A_log`` and ``D`` and the norm scales have rank >= 2,
    so they reach the model in the compute dtype too (ROADMAP.md, R6).
    """
    return {k: _cast(v, dtype) if isinstance(v, dict) else
            (v.to(dtype) if v.dtype == torch.float32 and v.ndim > 1 else v)
            for k, v in params.items()}


def loss_and_grads(cfg: ModelConfig, tcfg: TrainConfig, params: Dict, batch: Dict):
    """``(loss, {"ce", "z_loss"}, grads)`` of one batch: the loss of
    ``forward_train`` on the parameters cast with :func:`_cast`, and its
    float32 gradient with respect to the masters ``params``, in their
    layout; a parameter the batch does not reach (a VLM's ``prefix_proj``
    without ``prefix_emb``) gets zeros, as under ``jax.grad``.  ``batch``
    holds tensors on the parameters' device."""
    masters = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logits = forward_train(cfg, _cast(_rebuild(params, masters), _dtype(cfg)), batch)
    loss, metrics = cross_entropy_loss(logits, batch["labels"], tcfg.z_loss)
    del logits
    grads = torch.autograd.grad(loss, masters, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _rebuild(params, list(grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``tokens`` and ``labels`` ``(B, S)`` (tensors or numpy
    arrays).  With ``tcfg.microbatch > 1`` the batch is cut into that many
    equal parts along B, their gradients summed in float32 and divided by
    the count, as the reference's ``lax.scan`` does; the metrics are then
    ``loss``, ``grad_norm`` and ``lr`` only, as there.  Otherwise they also
    hold ``ce`` and ``z_loss``.  The returned state holds the same tensors
    as the one passed in, updated in place (see :mod:`repro_torch.optim.adamw`),
    its ``step`` one more.  With ``tcfg.grad_compression`` the gradients
    are compressed before the update and the new error state replaces
    ``"err"``, as in the reference.
    """

    def grads_of(params: Dict, batch: Dict):
        if tcfg.microbatch and tcfg.microbatch > 1:
            nm = tcfg.microbatch
            b = batch["tokens"].shape[0]
            if b % nm:
                raise ValueError(f"batch {b} is not a multiple of microbatch {nm}")
            acc, total = None, 0.0
            for i in range(nm):
                part = {k: v[i * (b // nm):(i + 1) * (b // nm)] for k, v in batch.items()}
                loss, _, grads = loss_and_grads(cfg, tcfg, params, part)
                grads = list(tree_leaves(grads))
                acc = grads if acc is None else [a.add_(g) for a, g in zip(acc, grads)]
                total = total + loss
            return total / nm, {}, _rebuild(params, [g.div_(nm) for g in acc])
        return loss_and_grads(cfg, tcfg, params, batch)

    def train_step(state: Dict[str, Any], batch: Dict):
        dev = state["step"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, metrics, grads = grads_of(state["params"], batch)
        new_state = dict(state)
        if tcfg.grad_compression != "none":
            grads, new_state["err"] = compression.compress_grads(grads, state["err"], tcfg.grad_compression,
                                                                 tcfg.compression_topk)
        params, opt, opt_metrics = adamw_update(tcfg, state["params"], grads, state["opt"], state["step"])
        new_state.update(step=state["step"] + 1, params=params, opt=opt)
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    compute_dtype = _dtype(cfg)

    def prefill_step(params: Dict, batch: Dict, cache_len: int = 0):
        """``(last-position logits (B, V), caches)`` for ``batch["tokens"]``
        (with its ``prefix_emb`` or ``frames``), the attention caches of
        ``cache_len`` (the sequence's length when 0).  As in the reference,
        an audio model's ``enc_kv`` is not returned: a caller that decodes
        takes it from ``forward_prefill`` or ``encoder_forward``."""
        logits, caches, _ = forward_prefill(cfg, _cast(params, compute_dtype), batch, cache_len)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    compute_dtype = _dtype(cfg)

    def decode_step(params: Dict, caches: Dict, token: torch.Tensor, pos: torch.Tensor, enc_kv=None):
        """``(logits (B, V), caches)``; the caches are updated in place; an
        audio model's cross-attention reads ``enc_kv``."""
        return forward_decode(cfg, _cast(params, compute_dtype), caches, token, pos, enc_kv=enc_kv)

    return decode_step
