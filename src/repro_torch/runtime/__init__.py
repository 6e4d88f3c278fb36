"""Host-side runtime: straggler watch and the restart-on-failure supervisor."""

from .fault_tolerance import StragglerMonitor, TrainLoopSupervisor

__all__ = ["StragglerMonitor", "TrainLoopSupervisor"]
