"""Shared arithmetic of the metric readers (not a metric: no entry in BENCHMARK.json names it)."""

from __future__ import annotations

import math
from typing import List, Optional, Tuple


def served(run, key: str) -> Tuple[List[dict], float]:
    """Every request or step issued in the window that did not fail, and
    the seconds from the window's start until the last of them was done:
    a rate over all the window's work and all its time, the last request
    or step included, so that a run a little slower reads a little lower
    instead of one whole request fewer."""
    recs = run.records.get(key, [])
    return [r for r in recs if r["ok"]], max([run.seconds] + [r["t_done"] for r in recs])


def p95(values: List[float]) -> Optional[float]:
    """The nearest-rank 95th percentile."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def on_card(run) -> bool:
    return run.device == "cuda"
