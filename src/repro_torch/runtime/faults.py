"""Deterministic fault injection for the guarded dispatch.

The port's own copy of the reference's ``repro/runtime/faults.py``: the
same plan grammar, the same ``REPRO_FAULTS`` variable and the same
per-op call counters, so one plan drives both packages.  Faults are rare
and nondeterministic on a real card (a refused launch, a shared-memory
request past the block's limit, a corrupted exchange, a NaN key from
upstream); a plan makes each class reproducible:

* a **fault plan** selects (fault class, op, call indices, attempt label);
* plans come from ``REPRO_FAULTS`` or from the stackable :func:`inject`
  context manager;
* the NaN positions are drawn from a numpy generator seeded with
  ``zlib.crc32`` of a salt, never from the clock or from ``hash()``, so a
  salt laces the same positions in both packages and a run replays.

Fault classes
-------------
``launch``
    The selected attempt raises :class:`InjectedFault` instead of
    launching.
``vmem``
    The preflight counts the attempt's shared-memory request as past the
    block's limit (no kernel is launched).  The name is the reference's
    (its check models a TPU's VMEM), so plans parse in both packages.
``exchange``
    The attempt's result is corrupted (first minimum and first maximum
    swapped) after it runs, so the verifier must reject it.
``nan``
    The float key operands are laced with NaNs before the call.

Plan grammar
------------
``;``-separated specs ``cls:op:indices[:match]``: ``cls`` one of
``launch | vmem | exchange | nan``; ``op`` a guarded op name
(``merge``, ``sort_batched``, ``distributed_merge``, ``serving.decode``,
...) or a pattern such as ``*``; ``indices`` comma-separated 0-based
per-op call indices, or ``*``; ``match`` an optional substring of the
attempt label (``kernel``, ``plain``, ``window``, ``capacity-2x``, ...).

Example: ``launch:merge:0,2;nan:sort*:*`` fails the launch of merge calls
0 and 2 and NaN-laces the keys of every ``sort*`` call.
"""

from __future__ import annotations

import contextlib
import fnmatch
import os
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "FAULT_CLASSES",
    "FaultEvent",
    "FaultSpec",
    "InjectedFault",
    "active",
    "corrupt",
    "fired_events",
    "inject",
    "maybe_nan_lace",
    "nan_lace",
    "next_index",
    "parse_plan",
    "reset_counters",
    "should_fire",
]

FAULT_CLASSES = ("launch", "vmem", "exchange", "nan")


class InjectedFault(RuntimeError):
    """Raised by an attempt selected for a ``launch`` fault."""


@dataclass(frozen=True)
class FaultSpec:
    """One parsed ``cls:op:indices[:match]`` clause of a fault plan."""

    cls: str
    op: str = "*"
    indices: Optional[Tuple[int, ...]] = None  # None == every call
    match: str = ""  # substring filter on the attempt label; "" == default

    def selects(self, cls: str, op: str, index: int) -> bool:
        if cls != self.cls:
            return False
        if not fnmatch.fnmatchcase(op, self.op):
            return False
        return self.indices is None or index in self.indices


@dataclass(frozen=True)
class FaultEvent:
    """Audit record of one fault that actually fired."""

    cls: str
    op: str
    index: int
    label: str


# ---------------------------------------------------------------------------
# plan state: env plan (cached on the raw env value) + an inject() stack
# ---------------------------------------------------------------------------

_ENV_VAR = "REPRO_FAULTS"
_STACK: List[Tuple[FaultSpec, ...]] = []
_ENV_CACHE: Tuple[str, Tuple[FaultSpec, ...]] = ("", ())
_COUNTERS: Dict[str, int] = {}
_FIRED: List[FaultEvent] = []


def parse_plan(plan: str) -> Tuple[FaultSpec, ...]:
    """Parse a ``;``-separated plan string into :class:`FaultSpec` tuples."""
    specs = []
    for clause in plan.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(":")
        if len(parts) < 2 or len(parts) > 4:
            raise ValueError(f"bad fault clause {clause!r} (want cls:op[:indices[:match]])")
        cls, op = parts[0].strip(), parts[1].strip()
        if cls not in FAULT_CLASSES:
            raise ValueError(f"unknown fault class {cls!r} (want one of {FAULT_CLASSES})")
        raw_idx = parts[2].strip() if len(parts) > 2 else "*"
        indices: Optional[Tuple[int, ...]]
        if raw_idx in ("", "*"):
            indices = None
        else:
            indices = tuple(int(tok) for tok in raw_idx.split(",") if tok.strip())
        match = parts[3].strip() if len(parts) > 3 else ""
        specs.append(FaultSpec(cls=cls, op=op or "*", indices=indices, match=match))
    return tuple(specs)


def _env_specs() -> Tuple[FaultSpec, ...]:
    global _ENV_CACHE
    raw = os.environ.get(_ENV_VAR, "")
    if raw != _ENV_CACHE[0]:
        _ENV_CACHE = (raw, parse_plan(raw))
    return _ENV_CACHE[1]


def _specs() -> Tuple[FaultSpec, ...]:
    specs = _env_specs()
    for layer in _STACK:
        specs = specs + layer
    return specs


def active() -> bool:
    """True when any fault plan (env or :func:`inject`) is in force."""
    return bool(_specs())


@contextlib.contextmanager
def inject(plan: str):
    """Context manager activating ``plan`` (stacks on top of ``REPRO_FAULTS``).

    Per-op call counters and the fired-event log are snapshotted on entry
    and restored on exit, so each ``with inject(...)`` block sees call
    index 0 for every op and leaves no trace behind.
    """
    specs = parse_plan(plan)
    saved_counters = dict(_COUNTERS)
    saved_fired = list(_FIRED)
    _COUNTERS.clear()
    _FIRED.clear()
    _STACK.append(specs)
    try:
        yield
    finally:
        _STACK.pop()
        _COUNTERS.clear()
        _COUNTERS.update(saved_counters)
        _FIRED[:] = saved_fired


def next_index(op: str) -> int:
    """Return this call's 0-based index for ``op`` and advance the counter.

    Called exactly once per guarded call (not per attempt), so a plan's
    ``indices`` address the same calls in both packages.
    """
    idx = _COUNTERS.get(op, 0)
    _COUNTERS[op] = idx + 1
    return idx


def reset_counters() -> None:
    """Zero every per-op call counter and clear the fired-event log."""
    _COUNTERS.clear()
    _FIRED.clear()


def should_fire(cls: str, op: str, index: int, label: str = "", last: bool = False) -> bool:
    """Pure query: does the active plan fire ``cls`` on this attempt?

    ``label`` is the dispatch attempt label; a spec with an explicit
    ``match`` fires only when ``match`` is a substring of ``label``.  A
    spec *without* a match skips an attempt passed ``last=True``: the
    reference's oracle edge.  The port has no oracle, and its guard never
    passes it, so such a spec fires on the port's one attempt.  Fires are
    recorded in :func:`fired_events`.
    """
    for spec in _specs():
        if not spec.selects(cls, op, index):
            continue
        if spec.match:
            if spec.match not in label:
                continue
        elif last:
            continue
        _FIRED.append(FaultEvent(cls=cls, op=op, index=index, label=label))
        return True
    return False


def fired_events() -> List[FaultEvent]:
    """Copy of every fault that fired since the last reset/inject entry."""
    return list(_FIRED)


# ---------------------------------------------------------------------------
# deterministic payload mutators
# ---------------------------------------------------------------------------


def _rng(salt: str) -> np.random.Generator:
    # crc32, not hash(): the same across processes, runs and packages
    return np.random.default_rng(zlib.crc32(salt.encode("utf-8")))


def nan_lace(x, salt: str):
    """``x`` with ~1/8 of its elements (at least one) replaced by NaN.

    The positions are drawn on the host from the crc32(salt)-seeded
    generator, as the reference draws them, and written on ``x``'s device.
    A tensor that is not floating point, or empty, is returned unchanged.
    """
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.numel() == 0:
        return x
    count = max(1, x.numel() // 8)
    pos = torch.from_numpy(_rng(salt).choice(x.numel(), size=count, replace=False)).to(x.device)
    flat = x.reshape(-1).clone()
    flat[pos] = float("nan")
    return flat.reshape(x.shape)


def _first(flat: torch.Tensor, value: torch.Tensor) -> int:
    """The first position of ``value`` in ``flat`` (argmax takes the first)."""
    return int(torch.argmax((flat == value).to(torch.uint8)))


def corrupt(x, salt: str = ""):
    """Corrupt an attempt's result (the ``exchange`` fault), on its device.

    Swaps the elements at the first minimum and the first maximum of the
    flattened tensor, NaNs ignored (keys only, for a tuple), as the
    reference does.  On a tensor that is not constant this breaks its
    order, so the verifier must reject it; a constant tensor is returned
    unchanged.  ``salt`` is kept for the reference's signature.
    """
    if isinstance(x, tuple):
        return (corrupt(x[0], salt),) + tuple(x[1:])
    if x.numel() < 2:
        return x
    flat = x.reshape(-1)
    real = flat[~torch.isnan(flat)] if x.is_floating_point() else flat
    if real.numel() == 0:
        return x
    lo, hi = real.min(), real.max()
    if bool(lo == hi):
        return x
    i, j = _first(flat, lo), _first(flat, hi)
    out = flat.clone()
    out[i], out[j] = flat[j], flat[i]
    return out.reshape(x.shape)


def maybe_nan_lace(op: str, index: int, args: tuple, key_positions: Sequence[int]) -> tuple:
    """Lace the key operands of a guarded call when a ``nan`` fault selects it.

    ``key_positions`` index the key tensors in ``args`` (values are never
    laced).  The salts are ``"{op}:{index}:{pos}"``, the reference's, so
    a test can rebuild the laced operands with :func:`nan_lace`.
    """
    if not key_positions or not should_fire("nan", op, index):
        return args
    out = list(args)
    for pos in key_positions:
        out[pos] = nan_lace(out[pos], f"{op}:{index}:{pos}")
    return tuple(out)
