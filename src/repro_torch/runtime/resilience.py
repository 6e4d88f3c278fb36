"""Guarded kernel dispatch: preflight, verification, health counters.

The port's copy of the reference's ``repro/runtime/resilience.py``.  Every
public entry point of ``repro_torch.kernels.ops``, ``ssm_scan`` and the
distributed merges, sort and top-k of ``repro_torch.core.distributed``
route through :func:`guarded_call`.  The reference walks a fallback chain
(``pallas-hier -> pallas-matrix -> core -> core-resort``); the port does
not: on a CUDA tensor a second engine would hide a failing kernel.  So a
call has one attempt, labelled ``"kernel"`` for a CUDA tensor and
``"plain"`` for a CPU one, and the guard

1. runs the **preflight**: the length bound (ranks are int32), tile and
   leaf legality (a power-of-two tile for the sorts), and the launch's
   dynamic shared-memory request against the 227 KB a Hopper block may
   hold; a failure raises :class:`GuardedDispatchError`;
2. **launches**: an exception out of the attempt, or an injected
   ``launch`` fault, raises :class:`GuardedDispatchError`, carrying the
   log and chained from the cause;
3. **verifies** (when verification is active): an op's verifier checks
   the output's order on the device; a failure raises
   :class:`VerificationError`.

The one second attempt anywhere is ``distributed_sort``'s
``capacity-2x``: the same sample sort on the same kernels at twice the
capacity factor, which re-routes nothing.

Verification policy, as the reference's: off for the single-host ops
unless a fault plan is active or ``REPRO_GUARD_VERIFY=1`` (``=0`` forces
it off), always on for the distributed calls.  The verifiers compare the
total-order keys of neighbours on the device and read the host once.

The guard steps aside (the attempt runs directly) when ``REPRO_GUARD=0``,
under ``torch.compile`` and while a CUDA graph is captured: there the
host cannot branch on the device's results.  ``REPRO_GUARD_DEVICE`` of
the reference keys TPU budgets and has no counterpart here.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import checker as _checker
from repro_torch.analysis.registry import REGISTRY
from repro_torch.telemetry import get_telemetry

from . import faults as _faults

__all__ = [
    "FallbackWarning",
    "GuardedDispatchError",
    "OpHealth",
    "SMEM_PER_BLOCK",
    "VerificationError",
    "attempt_label",
    "guard_enabled",
    "guarded_call",
    "health",
    "health_summary",
    "is_tracing",
    "keys_ordered",
    "preflight",
    "reset_health",
    "sorted_kv_verifier",
    "sorted_verifier",
    "topk_verifier",
    "verify_active",
]

# the dynamic shared memory a block may request, as the kernel checker's budget
# states it (its one definition: repro_torch.analysis.checker)
SMEM_PER_BLOCK = int(_checker.SMEM_BUDGET_BYTES["h100"] * _checker.SMEM_USABLE_FRACTION)
_MAX_N = 2**31 - 1  # ranks and cut tables are int32


class FallbackWarning(UserWarning):
    """Emitted when a call is served by an attempt after its first
    (``distributed_sort``'s ``capacity-2x``)."""


class GuardedDispatchError(RuntimeError):
    """No attempt launched: a preflight, a launch or an injected fault
    failed.  Carries the attempt log."""

    def __init__(self, op: str, log: List[str]):
        self.op = op
        self.log = list(log)
        super().__init__(f"guarded dispatch failed for {op!r}: " + "; ".join(log))


class VerificationError(RuntimeError):
    """An attempt's output failed its verifier."""


# ---------------------------------------------------------------------------
# policy switches
# ---------------------------------------------------------------------------


def guard_enabled() -> bool:
    """Guarded dispatch is on unless ``REPRO_GUARD=0``."""
    return os.environ.get("REPRO_GUARD", "1") != "0"


def verify_active() -> bool:
    """Whether a single-host call verifies its output (see the module docstring)."""
    raw = os.environ.get("REPRO_GUARD_VERIFY", "")
    if raw == "1":
        return True
    if raw == "0":
        return False
    return _faults.active()


def is_tracing() -> bool:
    """True under ``torch.compile`` or while a CUDA graph is captured."""
    if torch.compiler.is_compiling():
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def attempt_label(x: torch.Tensor) -> str:
    """The label of a single-host call's one attempt: ``"kernel"`` on a CUDA
    tensor, ``"plain"`` on a CPU one."""
    return "kernel" if x.is_cuda else "plain"


# ---------------------------------------------------------------------------
# health counters
# ---------------------------------------------------------------------------


@dataclass
class OpHealth:
    """Counters of one guarded op, the reference's fields."""

    calls: int = 0
    fallbacks: int = 0
    precondition_rejects: int = 0
    launch_failures: int = 0
    verify_failures: int = 0
    faults_injected: int = 0
    exhausted: int = 0
    served_by: Dict[str, int] = field(default_factory=dict)
    fallback_edges: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "calls": self.calls,
            "fallbacks": self.fallbacks,
            "precondition_rejects": self.precondition_rejects,
            "launch_failures": self.launch_failures,
            "verify_failures": self.verify_failures,
            "faults_injected": self.faults_injected,
            "exhausted": self.exhausted,
            "served_by": dict(self.served_by),
            "fallback_edges": dict(self.fallback_edges),
        }


# the records live in the active telemetry registry, so traces and the
# ``python -m repro_torch.telemetry`` CLI see the same counters


def health(op: str) -> OpHealth:
    """The (auto-created) health record of ``op``."""
    store = get_telemetry().health
    rec = store.get(op)
    if rec is None:
        rec = store[op] = OpHealth()
    return rec


def reset_health() -> None:
    """Drop every per-op health record."""
    get_telemetry().health.clear()


def health_summary() -> dict:
    """``{op: counters}`` plus a ``"totals"`` roll-up across the ops."""
    store = get_telemetry().health
    totals = OpHealth()
    per_op = {}
    for op in sorted(store):
        rec = store[op]
        per_op[op] = rec.as_dict()
        for name in ("calls", "fallbacks", "precondition_rejects", "launch_failures", "verify_failures",
                     "faults_injected", "exhausted"):
            setattr(totals, name, getattr(totals, name) + getattr(rec, name))
    per_op["totals"] = totals.as_dict()
    return per_op


# ---------------------------------------------------------------------------
# preflight
# ---------------------------------------------------------------------------


def preflight(op: str, meta: Optional[dict], label: str, index: int) -> List[str]:
    """Reasons this attempt must not launch (empty: go).

    ``meta`` is the call's geometry (``n``, ``tile``, ``leaf``, and
    ``smem``: the dynamic shared memory of the largest block the call
    launches, from ``kernels.merge_path.smem_bytes``).  Checks ``0 <= n <=
    int32 max``, ``tile >= 1``, ``1 <= leaf <= tile``, a power-of-two tile
    where the op's contract says ``pow2_tile`` (the registry of
    :mod:`repro_torch.analysis.registry`), and ``smem`` against
    :data:`SMEM_PER_BLOCK`, the checker's budget; an injected ``vmem``
    fault counts as a breach of that last check.  A call without ``smem``
    (``merge_k``, whose rounds are guarded calls of their own, and
    ``ssm_scan``, whose request K9's source fixes at compile time and
    ``chip_smoke.py`` holds equal to the checker's model) skips it, as the
    reference's checks only its Pallas attempts.
    """
    if meta is None:
        return []
    reasons: List[str] = []
    n = meta.get("n")
    if n is not None and not (0 <= int(n) <= _MAX_N):
        reasons.append(f"n={n} outside [0, {_MAX_N}]")
    tile, leaf = meta.get("tile"), meta.get("leaf")
    contract = REGISTRY.get(op)
    if tile is not None:
        if int(tile) < 1:
            reasons.append(f"tile={tile} < 1")
        elif contract is not None and contract.pow2_tile and int(tile) & (int(tile) - 1):
            reasons.append(f"tile={tile} not a power of two ({op})")
        if leaf is not None and not (1 <= int(leaf) <= int(tile)):
            reasons.append(f"leaf={leaf} outside [1, tile={tile}]")
    if not reasons and "smem" in meta:  # a call that launches a merge-path kernel itself
        smem = int(meta["smem"])
        if _faults.should_fire("vmem", op, index, label=label):
            health(op).faults_injected += 1
            reasons.append(f"injected vmem fault: shared memory counted past {SMEM_PER_BLOCK} B for {label}")
        elif smem > SMEM_PER_BLOCK:
            reasons.append(f"shared memory {smem} B a block exceeds {SMEM_PER_BLOCK} B for {label}")
    return reasons


# ---------------------------------------------------------------------------
# verifiers: total-order comparisons on the device
# ---------------------------------------------------------------------------


def keys_ordered(keys: torch.Tensor, lens=None, descending: bool = False) -> torch.Tensor:
    """A 0-d bool tensor on ``keys``' device: every row of ``keys`` (1-D or
    ``(R, L)``) is nondecreasing (nonincreasing with ``descending``) in
    total-order space over its first ``lens[r]`` elements (all of them
    when ``lens`` is None).  Neighbours are compared, never subtracted:
    a difference of two extreme keys wraps."""
    from repro_torch.core.merge_path import total_order_keys  # the core imports this module

    tok = total_order_keys(keys)
    tok = tok[None, :] if tok.ndim == 1 else tok
    if tok.shape[1] < 2:
        return torch.ones((), dtype=torch.bool, device=keys.device)
    ok = tok[:, 1:] <= tok[:, :-1] if descending else tok[:, :-1] <= tok[:, 1:]
    if lens is not None:
        lens = torch.as_tensor(lens, device=keys.device).reshape(-1, 1)
        cols = torch.arange(tok.shape[1] - 1, device=keys.device)[None, :]
        ok = ok | (cols >= lens - 1)
    return ok.all()


def sorted_verifier(lens=None) -> Callable:
    """Verifier: the output keys (the first element of a tuple) are
    nondecreasing in total-order space over each row's first ``lens[r]``
    (a ragged merge's valid prefix: past it lie sentinel pads, which a NaN
    inside it would sort after)."""

    def check(out) -> Optional[str]:
        keys = out[0] if isinstance(out, tuple) else out
        if not bool(keys_ordered(keys, lens)):
            return "output keys not nondecreasing in total-order space"
        return None

    return check


def sorted_kv_verifier(lens=None) -> Callable:
    """:func:`sorted_verifier` (a tuple's keys are verified)."""
    return sorted_verifier(lens)


def topk_verifier(descending: bool = True) -> Callable:
    """Verifier of ``(values, indices)`` top-k output: the valid slots
    (``indices >= 0``; masked ragged slots hold ``-1``) are nonincreasing
    in total-order space, where NaN is the largest key."""

    def check(out) -> Optional[str]:
        vals, idx = out
        idx = idx[None, :] if idx.ndim == 1 else idx
        if not bool(keys_ordered(vals, (idx >= 0).sum(1), descending=descending)):
            return "top-k values not nonincreasing over valid slots"
        return None

    return check


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def guarded_call(
    op: str,
    attempts: Sequence[Tuple[str, Callable[[], object]]],
    *,
    index: Optional[int] = None,
    meta: Optional[dict] = None,
    verifier: Optional[Callable] = None,
    verify: Optional[bool] = None,
):
    """Run one call of ``op``: its attempts in order, the first good result.

    ``attempts`` is ``[(label, thunk)]``: one attempt, or
    ``distributed_sort``'s two.  ``index`` is the call's position in the
    op's stream (``faults.next_index``), taken here when None.
    ``verify=None`` defers to :func:`verify_active`.  When every attempt
    failed, the last failure decides the error: a verifier's
    (:class:`VerificationError`, also from a guarded call nested in the
    attempt) or any other (:class:`GuardedDispatchError`), chained from
    its cause.
    """
    if index is None:
        index = _faults.next_index(op)
    rec = health(op)
    rec.calls += 1
    run_verify = verify_active() if verify is None else verify
    log: List[str] = []
    last_err: Optional[BaseException] = None
    attrs = {k: v for k, v in (meta or {}).items() if v is not None and k != "smem"}
    with get_telemetry().span(f"op/{op}", index=index, **attrs) as sp:
        for i, (label, thunk) in enumerate(attempts):
            reasons = preflight(op, meta, label, index)
            if reasons:
                rec.precondition_rejects += 1
                last_err = None
                log.append(f"{label}: preflight rejected ({'; '.join(reasons)})")
                continue
            if _faults.should_fire("launch", op, index, label=label):
                rec.faults_injected += 1
                rec.launch_failures += 1
                last_err = _faults.InjectedFault(f"injected launch failure: {op}[{index}] {label}")
                log.append(f"{label}: {last_err}")
                continue
            try:
                out = thunk()
            except VerificationError as err:  # a nested guarded call's verdict
                rec.verify_failures += 1
                last_err = err
                log.append(f"{label}: nested verify failed ({err})")
                continue
            except Exception as err:  # lint: ok(L006) the port's one launch catch: it raises below
                rec.launch_failures += 1
                last_err = err
                log.append(f"{label}: {type(err).__name__}: {err}")
                continue
            if _faults.should_fire("exchange", op, index, label=label):
                rec.faults_injected += 1
                out = _faults.corrupt(out, f"{op}:{index}:{label}")
            if run_verify and verifier is not None:
                problem = verifier(out)
                if problem is not None:
                    rec.verify_failures += 1
                    last_err = VerificationError(f"{op}[{index}] {label}: {problem}")
                    log.append(f"{label}: verify failed ({problem})")
                    continue
            rec.served_by[label] = rec.served_by.get(label, 0) + 1
            sp.set("served_by", label)
            if i > 0:
                rec.fallbacks += 1
                edge = f"{attempts[0][0]}->{label}"
                rec.fallback_edges[edge] = rec.fallback_edges.get(edge, 0) + 1
                sp.set("degraded", edge)
                warnings.warn(f"guarded dispatch: {op}[{index}] served by {label} ({log[-1]})", FallbackWarning,
                              stacklevel=3)
            return out
        rec.exhausted += 1
        sp.set("exhausted", True)
    if isinstance(last_err, VerificationError):
        raise VerificationError(f"{op}[{index}]: " + "; ".join(log)) from last_err
    raise GuardedDispatchError(op, log) from last_err
