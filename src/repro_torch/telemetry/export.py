"""Trace export: Chrome/Perfetto ``trace_event`` JSON and flat summaries.

The port's copy of the reference's ``repro/telemetry/export.py``, with
the same event fields, key order and separators, so a tick-clocked trace
of the same workload serializes to the same bytes in both packages.
Closed spans become complete ``"X"`` events with ``ts``/``dur`` in trace
microseconds; unclosed spans become lone ``"B"`` events (``--check``
flags them).  Everything in the trace is a function of the recorded
event stream; the histograms, which may hold wall-time samples, go to
:func:`summary` only.
"""

from __future__ import annotations

import json
from typing import Dict

from .spans import Telemetry


def _health_dict(tel: Telemetry) -> Dict[str, dict]:
    return {op: h.as_dict() for op, h in sorted(tel.health.items())}


def chrome_trace(tel: Telemetry) -> dict:
    """Chrome ``trace_event`` JSON object (deterministic content only)."""
    events = []
    for sp in tel.spans:
        ev = {"name": sp.name, "cat": "repro", "pid": 1, "tid": 1 + sp.depth, "ts": sp.start, "args": sp.attrs}
        if sp.end is None:
            ev["ph"] = "B"
        else:
            ev["ph"] = "X"
            ev["dur"] = sp.end - sp.start
        events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock": tel.clock.kind,
            "unclosed_spans": len(tel.unclosed()),
            "spans": tel.span_stats(),
            "counters": {k: c.value for k, c in tel.counters.items()},
            "gauges": {k: g.as_dict() for k, g in tel.gauges.items()},
            "health": _health_dict(tel),
        },
    }


def summary(tel: Telemetry) -> dict:
    """Flat summary dict; unlike :func:`chrome_trace` it holds the histograms."""
    return {
        "clock": tel.clock.kind,
        "unclosed_spans": len(tel.unclosed()),
        "spans": tel.span_stats(),
        "counters": {k: c.value for k, c in tel.counters.items()},
        "gauges": {k: g.as_dict() for k, g in tel.gauges.items()},
        "histograms": {k: h.stats() for k, h in tel.histograms.items()},
        "health": _health_dict(tel),
    }


def trace_json_bytes(tel: Telemetry) -> bytes:
    """The canonical serialized trace: sorted keys, fixed separators, so two
    identical event streams compare equal as bytes."""
    return json.dumps(chrome_trace(tel), sort_keys=True, separators=(",", ":")).encode("utf-8")


def write_trace(tel: Telemetry, path) -> None:
    with open(path, "wb") as f:
        f.write(trace_json_bytes(tel))


def load_trace(path) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
