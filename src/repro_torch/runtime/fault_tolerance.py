"""Fault tolerance: heartbeat failure detection, straggler watch, elastic
remesh plan, restart on failure.

The port's own copy of the reference's ``repro/runtime/fault_tolerance.py``.
The logic is host-side and is tested with simulated clocks and failures;
times are read on the port's own clock
(:func:`repro_torch.telemetry.wall_seconds`).  After a loss of hosts,
:func:`plan_elastic_mesh` gives the mesh to rebuild and
:meth:`repro_torch.checkpoint.CheckpointManager.restore` with ``shardings=``
puts the checkpoint onto it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Tuple

from repro_torch.telemetry import wall_seconds


@dataclasses.dataclass
class HeartbeatMonitor:
    """Declares a host dead after ``timeout`` seconds of silence."""

    num_hosts: int
    timeout: float = 60.0
    clock: Callable[[], float] = wall_seconds

    def __post_init__(self):
        now = self.clock()
        self.last_seen = {h: now for h in range(self.num_hosts)}

    def beat(self, host: int) -> None:
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout]

    def healthy(self) -> bool:
        return not self.dead_hosts()


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than ``factor`` x the rolling median.

    A flagged straggler is reported; after ``patience`` consecutive flags
    :meth:`should_remesh` asks for an elastic remesh that excludes the slow
    host (the same restart path as a failure, but planned).
    """

    window: int = 50
    factor: float = 2.0
    patience: int = 5

    def __post_init__(self):
        self.times: List[float] = []
        self.flags = 0

    def record(self, step_time: float) -> bool:
        med = sorted(self.times)[len(self.times) // 2] if self.times else step_time
        self.times.append(step_time)
        if len(self.times) > self.window:
            self.times.pop(0)
        slow = len(self.times) > 5 and step_time > self.factor * med
        self.flags = self.flags + 1 if slow else 0
        return slow

    def should_remesh(self) -> bool:
        return self.flags >= self.patience


def plan_elastic_mesh(
    available_chips: int,
    model_parallel: int,
    prefer_pods: bool = True,
    chips_per_pod: int = 256,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest usable ``(pod, data, model)`` mesh shape and its dimension
    names from the surviving chips.

    Keeps the tensor-parallel degree fixed (the parameters' placements stay
    valid) and shrinks the data and pod dimensions; the restore then
    distributes the checkpoint onto the new mesh.
    """
    if available_chips < model_parallel:
        raise ValueError(f"need >= {model_parallel} chips, have {available_chips}")
    pods = available_chips // chips_per_pod
    if prefer_pods and pods >= 2:
        data = chips_per_pod // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    data = available_chips // model_parallel
    # the largest power-of-two data degree keeps batch divisibility simple
    data = 1 << int(math.log2(data))
    return (data, model_parallel), ("data", "model")


@dataclasses.dataclass
class TrainLoopSupervisor:
    """Wraps the step loop: checkpoint cadence and restore-and-continue on
    failure, at most ``max_failures`` times."""

    checkpoint_every: int
    max_failures: int = 3

    def __post_init__(self):
        self.failures = 0

    def run(
        self,
        start_step: int,
        total_steps: int,
        step_fn: Callable[[int], None],
        save_fn: Callable[[int], None],
        restore_fn: Callable[[], int],
    ) -> int:
        """Runs steps with restart-on-exception; returns the final step."""
        step = start_step
        while step < total_steps:
            try:
                step_fn(step)
                step += 1
                if step % self.checkpoint_every == 0:
                    save_fn(step)
            except Exception:
                self.failures += 1
                if self.failures > self.max_failures:
                    raise
                step = restore_fn()
        return step
