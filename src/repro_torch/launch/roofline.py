"""Roofline terms of a dry-run cell, on the NVIDIA H100 SXM's numbers.

The port's counterpart of the reference's ``repro/launch/roofline.py``.
Three terms per (arch x shape x mesh) cell, in seconds, per device:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = wire_bytes_per_device / LINK_BW

The reference reads flops and bytes from XLA's cost analysis and parses
the collectives out of the optimized HLO.  The port has no HLO: its dry
run (:mod:`repro_torch.launch.dryrun`) counts the operations of one eager
step on meta DTensors and records every collective the DTensor layer
issues; :func:`collective_bytes` sums those records with the reference's
multipliers (all-reduce 2x, for its reduce-scatter and all-gather halves;
the others 1x, the ring's ``(n - 1) / n`` taken as 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

# --- NVIDIA H100 SXM constants (per card) ---
PEAK_FLOPS = 989e12  # bfloat16 dense on the tensor cores (NVIDIA's H100 datasheet, SXM, without sparsity)
HBM_BW = 3.35e12  # bytes/s, the HBM3 rate of the datasheet: the bound PERF.md section 6 and chip_smoke.py use
LINK_BW = 450e9  # bytes/s each way over NVLink 4 (18 links of 25 GB/s each way, the datasheet's 900 GB/s total)

_COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0, "all-to-all": 1.0, "collective-permute": 1.0}


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Wire bytes per collective kind (with the multipliers) of ``records``,
    ``(kind, result bytes)`` pairs as the dry run records them; ``"counts"``
    holds the number of each kind."""
    out: Dict[str, float] = {k: 0.0 for k in _COLL_KINDS}
    counts = {k: 0 for k in _COLL_KINDS}
    for kind, nbytes in records:
        out[kind] += nbytes * _MULT[kind]
        counts[kind] += 1
    out["counts"] = counts  # type: ignore[assignment]
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    collective_detail: Dict[str, float]
    chips: int
    model_flops: float  # 6*N*D (train) or 2*N_active*D (inference), global

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory, "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """The roofline step time: the largest term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """Model flops over the flops counted across all devices."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline MFU: model flops / (chips * peak * t_step)."""
        denom = self.chips * PEAK_FLOPS * self.t_step
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "collective_detail": self.collective_detail,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_step_s": self.t_step,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(cfg, shape) -> float:
    """6*N*D for train, 2*N_active*D for inference (D = tokens processed)."""
    n_active = cfg.n_active_params()
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per row
