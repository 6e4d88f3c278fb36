"""Stdlib-only telemetry: spans on a wall or tick clock, counters, gauges, histograms."""

from .spans import (
    TICK_SCALE,
    WALL,
    Counter,
    Gauge,
    Histogram,
    Span,
    Telemetry,
    TickClock,
    WallClock,
    get_telemetry,
    wall_seconds,
)

__all__ = [
    "TICK_SCALE",
    "WALL",
    "Counter",
    "Gauge",
    "Histogram",
    "Span",
    "Telemetry",
    "TickClock",
    "WallClock",
    "get_telemetry",
    "wall_seconds",
]
