"""Host-side runtime: the guarded dispatch with its fault injector, the
heartbeat and straggler watches, the elastic mesh plan and the
restart-on-failure supervisor.

* :mod:`repro_torch.runtime.resilience`: guarded kernel dispatch that
  preflights, verifies and raises, with per-op health counters;
* :mod:`repro_torch.runtime.faults`: the deterministic fault injector
  (``REPRO_FAULTS`` and :func:`inject`);
* :mod:`repro_torch.runtime.fault_tolerance`: the heartbeat monitor, the
  train loop's straggler watch and supervisor, and the elastic mesh plan.
"""

from .fault_tolerance import HeartbeatMonitor, StragglerMonitor, TrainLoopSupervisor, plan_elastic_mesh
from .faults import FaultSpec, InjectedFault, fired_events, inject, nan_lace, parse_plan, reset_counters
from .resilience import (
    FallbackWarning,
    GuardedDispatchError,
    OpHealth,
    VerificationError,
    guard_enabled,
    guarded_call,
    health_summary,
    preflight,
    reset_health,
    verify_active,
)

__all__ = [
    "FallbackWarning",
    "FaultSpec",
    "GuardedDispatchError",
    "HeartbeatMonitor",
    "InjectedFault",
    "OpHealth",
    "StragglerMonitor",
    "TrainLoopSupervisor",
    "VerificationError",
    "fired_events",
    "guard_enabled",
    "guarded_call",
    "health_summary",
    "inject",
    "nan_lace",
    "parse_plan",
    "plan_elastic_mesh",
    "preflight",
    "reset_counters",
    "reset_health",
    "verify_active",
]
