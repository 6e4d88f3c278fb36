"""Fault tolerance of the train loop: straggler watch, restart on failure.

The port's own copy of the two parts of the reference's
``repro/runtime/fault_tolerance.py`` that its launcher uses; the heartbeat
monitor and the elastic mesh plan come with the parallel slice.  The logic
is host-side; step times are read on the port's own clock
(:func:`repro_torch.telemetry.wall_seconds`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List


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
