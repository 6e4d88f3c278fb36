"""Static analysis for the port's Merge Path kernels: prove the contracts
on a lattice, and hold them on the card.

The port's counterpart of the reference's ``repro/analysis``:

* :mod:`repro_torch.analysis.registry`: the :class:`KernelContract` every
  entry point of ``kernels/ops.py`` and the selective scan declares;
* :mod:`repro_torch.analysis.lattice`: the parameter points;
* :mod:`repro_torch.analysis.checker`: rules A000-A006, on the real
  wrappers run on small tensors (A001, A006, the rejections) and on a
  closed-form model of the port's launches (A002 coverage, A003 window
  reads, A005 shared memory against the 227 KB a Hopper block may hold).

The AST lint of the reference (``tools/lint_rules.py``) already covers
the port's sources.  Entry point: ``python -m repro_torch.analysis
[--fast] [--no-trace] [--device cpu|cuda]``.
"""

from .checker import (
    SMEM_BUDGET_BYTES,
    Violation,
    block_divisibility_violations,
    check_contract,
    check_kernels,
    completeness_violations,
    grad_violations,
    prefetch_violations,
    rejection_violations,
    sentinel_violations,
    shape_violations,
    smem_bytes,
    smem_violations,
)
from .lattice import LatticeConfig, model_lattice, scan_lattice, trace_lattice
from .registry import REGISTRY, KernelContract, kernel_contract, registered_contracts

__all__ = [
    "KernelContract",
    "kernel_contract",
    "registered_contracts",
    "REGISTRY",
    "LatticeConfig",
    "model_lattice",
    "trace_lattice",
    "scan_lattice",
    "Violation",
    "SMEM_BUDGET_BYTES",
    "check_kernels",
    "check_contract",
    "completeness_violations",
    "shape_violations",
    "block_divisibility_violations",
    "rejection_violations",
    "prefetch_violations",
    "sentinel_violations",
    "smem_bytes",
    "smem_violations",
    "grad_violations",
]
