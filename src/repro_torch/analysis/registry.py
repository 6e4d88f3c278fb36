"""Kernel contract registry: the declarative half of the static checker.

The port's copy of the reference's ``repro/analysis/registry.py``.  Every
public entry point of :mod:`repro_torch.kernels.ops` and
:func:`repro_torch.kernels.ssm_scan.ssm_scan` carries a
:func:`kernel_contract` annotation stating the invariants its kernels hold:

* **kind**: which model the checker applies (``repro_torch.analysis.
  checker``): the merges (K1, K2, K5-K8), the flat sorts (the tile sort S1,
  then K3 or K4 rounds), the top-k (the same sort on flipped keys), the
  k-way tournament (K7 rounds) and the selective scan (K9, K10);
* **masked_ranks**: whether the rank path excludes the pads past each
  side by *index*, so that a pad tied with a real ``+inf`` /
  ``iinfo.max`` key never steals its slot and surfaces a zero value.
  Contracts that carry values or ragged lengths MUST be masked; a
  keys-only contract may use an unmasked form, and must then state why it
  is safe in ``tie_safe``;
* **pow2_tile**: the flat sort rounds need ``tile | 2 * width`` with
  power-of-two widths, so the wrapper must *reject* a tile that is not a
  power of two (the checker verifies that it does);
* **differentiable**: the entry point carries a gradient (an autograd
  ``Function``, or autograd through a gather of the sorted order); the
  checker then also runs its backward.

This module imports nothing of the port: the annotations live on the hot
dispatch surface (``kernels/ops.py``) and cost nothing at import time.
The checks themselves live in :mod:`repro_torch.analysis.checker`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

# Models the checker knows how to apply.  "merge" covers the 1-D, batched
# and ragged merges (K1, K2, K5-K8: fixed output spans per block); "sort"
# the flat bottom-up sorts (S1, then K3 or K4 rounds over an (m + tile,)
# buffer); "topk" the flip-then-kv-sort reduction; "merge_k" the tournament
# of K7 rounds; "scan" the selective scan (K9, K10).
KINDS = ("merge", "sort", "topk", "merge_k", "scan")


@dataclass(frozen=True)
class KernelContract:
    """Declared invariants of one kernel entry point (see module doc)."""

    name: str
    kind: str
    fn: Any = field(default=None, repr=False, compare=False)
    batched: bool = False
    ragged: bool = False
    carries_values: bool = False
    masked_ranks: bool = False
    pow2_tile: bool = False
    differentiable: bool = False
    # justification for an unmasked rank path (keys-only contracts only):
    # why sentinel-tied real keys still merge bit-exactly
    tie_safe: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown contract kind {self.kind!r} (expected one of {KINDS})")

    def with_(self, **changes) -> "KernelContract":
        """A modified copy: the tests build known-bad contracts with it."""
        return replace(self, **changes)


# name -> contract, populated at kernels import time by the decorator
REGISTRY: Dict[str, KernelContract] = {}


def kernel_contract(
    *,
    kind: str,
    name: Optional[str] = None,
    batched: bool = False,
    ragged: bool = False,
    carries_values: bool = False,
    masked_ranks: bool = False,
    pow2_tile: bool = False,
    differentiable: bool = False,
    tie_safe: Optional[str] = None,
):
    """Decorator: register the wrapped kernel entry point's contract.

    Returns the function unchanged, so annotating a wrapper costs nothing
    at call time.
    """

    def deco(fn):
        cname = name or getattr(fn, "__name__", None)
        if not cname:
            raise ValueError("kernel_contract needs a name= for unnamed callables")
        REGISTRY[cname] = KernelContract(
            name=cname,
            kind=kind,
            fn=fn,
            batched=batched,
            ragged=ragged,
            carries_values=carries_values,
            masked_ranks=masked_ranks,
            pow2_tile=pow2_tile,
            differentiable=differentiable,
            tie_safe=tie_safe,
        )
        return fn

    return deco


def registered_contracts() -> Dict[str, KernelContract]:
    """A copy of the registry (import the kernel modules first: their
    decorators fill it)."""
    return dict(REGISTRY)
