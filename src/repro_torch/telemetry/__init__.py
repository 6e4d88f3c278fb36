"""Stdlib-only telemetry: spans on a wall or tick clock, counters, gauges,
exact-percentile histograms, the guarded dispatch's health registry, and
Chrome/Perfetto trace export (``python -m repro_torch.telemetry --help``)."""

from .export import chrome_trace, load_trace, summary, trace_json_bytes, write_trace
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
    reset_telemetry,
    use,
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
    "chrome_trace",
    "get_telemetry",
    "load_trace",
    "reset_telemetry",
    "summary",
    "trace_json_bytes",
    "use",
    "wall_seconds",
    "write_trace",
]
