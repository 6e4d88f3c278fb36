"""Telemetry core: spans on a pluggable clock, counters, gauges, histograms.

The port's own copy of the reference's ``repro/telemetry/spans.py``.  It
is stdlib-only.  One :class:`Telemetry` registry holds the spans,
counters, gauges and histograms, and the per-op health records of the
guarded dispatch (``repro_torch.runtime.resilience.OpHealth``, duck-typed
here so this module imports nothing of the port).  While the serving
engine steps it installs its :class:`TickClock`, so span timestamps count
engine ticks, never wall time, and a replayed workload gives the same
event stream.  The active registry is process-global
(:func:`get_telemetry`); tests and replays push a fresh one with
:func:`use`.
"""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

TICK_SCALE = 1_000_000  # one engine tick rendered as this many trace-us


class WallClock:
    """Wall time in microseconds."""

    kind = "wall"

    def now(self) -> float:
        # The port's copy of the repo's one sanctioned wall clock
        # (src/repro/telemetry/), which the rule exempts by path.
        return time.perf_counter() * 1e6  # lint: ok(L007)


WALL = WallClock()


def wall_seconds() -> float:
    """Monotonic wall seconds, the port's copy of the reference's
    ``repro.telemetry.wall_seconds``: host-side durations (step times)
    read it instead of a raw clock."""
    return WALL.now() / 1e6


class TickClock:
    """Deterministic clock counted in engine ticks: ``tick * TICK_SCALE + seq``,
    where ``seq`` counts reads within the tick."""

    kind = "tick"

    def __init__(self) -> None:
        self.tick = 0
        self._seq = 0

    def advance(self, tick: Optional[int] = None) -> None:
        self.tick = self.tick + 1 if tick is None else int(tick)
        self._seq = 0

    def now(self) -> int:
        ts = self.tick * TICK_SCALE + self._seq
        self._seq += 1
        return ts


class Span:
    """One timed region; ``end is None`` while it is open."""

    __slots__ = ("name", "start", "end", "depth", "attrs")

    def __init__(self, name: str, start, depth: int, attrs: Dict[str, object]):
        self.name = name
        self.start = start
        self.end = None
        self.depth = depth
        self.attrs = attrs

    def set(self, key: str, value: object) -> None:
        self.attrs[key] = value

    @property
    def duration(self):
        return None if self.end is None else self.end - self.start


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def add(self, v=1) -> None:
        self.value += v


class Gauge:
    """Last/min/max of a sampled value."""

    __slots__ = ("last", "min", "max")

    def __init__(self) -> None:
        self.last = None
        self.min = None
        self.max = None

    def set(self, v) -> None:
        self.last = v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def as_dict(self) -> dict:
        return {"last": self.last, "min": self.min, "max": self.max}


# 1-2-5 bucket ladder from 1 to 5e7; the last bucket is open.
DEFAULT_BOUNDS = tuple(m * 10**e for e in range(8) for m in (1, 2, 5))


class Histogram:
    """Fixed buckets plus the raw samples, so percentiles are exact
    (numpy's default linear interpolation)."""

    __slots__ = ("bounds", "bucket_counts", "samples")

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)
        self.samples: List[float] = []

    @property
    def count(self) -> int:
        return len(self.samples)

    def record(self, v) -> None:
        v = float(v)
        self.samples.append(v)
        self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        h = (len(s) - 1) * (q / 100.0)
        lo = int(h)
        if lo >= len(s) - 1:
            return s[-1]
        return s[lo] + (h - lo) * (s[lo + 1] - s[lo])

    def stats(self) -> dict:
        if not self.samples:
            return {"count": 0}
        return {
            "count": len(self.samples),
            "mean": sum(self.samples) / len(self.samples),
            "min": min(self.samples),
            "max": max(self.samples),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "buckets": [[self.bounds[i] if i < len(self.bounds) else None, c]
                        for i, c in enumerate(self.bucket_counts) if c],
        }


class Telemetry:
    """One registry of spans, counters, gauges, histograms and op health."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else WallClock()
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        # the guarded dispatch's OpHealth records (anything with .as_dict())
        self.health: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds)
        return h

    def begin(self, name: str, **attrs) -> Span:
        sp = Span(name, self.clock.now(), len(self._stack), dict(attrs))
        self.spans.append(sp)
        self._stack.append(sp)
        return sp

    def end(self, sp: Span) -> None:
        sp.end = self.clock.now()
        # an exception unwinding several spans ends them out of order
        while self._stack and self._stack.pop() is not sp:
            pass

    @contextmanager
    def span(self, name: str, **attrs) -> Iterator[Span]:
        sp = self.begin(name, **attrs)
        try:
            yield sp
        finally:
            self.end(sp)

    def unclosed(self) -> List[Span]:
        return [sp for sp in self.spans if sp.end is None]

    def span_stats(self) -> Dict[str, dict]:
        """Per-name count and total duration (trace-us) of the spans."""
        out: Dict[str, dict] = {}
        for sp in self.spans:
            rec = out.setdefault(sp.name, {"count": 0, "total_us": 0})
            rec["count"] += 1
            if sp.end is not None:
                rec["total_us"] += sp.end - sp.start
        return out

    @contextmanager
    def use_clock(self, clock) -> Iterator[None]:
        prev, self.clock = self.clock, clock
        try:
            yield
        finally:
            self.clock = prev

    def reset(self) -> None:
        self.spans.clear()
        self._stack.clear()
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self.health.clear()

    def snapshot(self) -> dict:
        """JSON-able state to ship across a process boundary."""
        return {
            "counters": {k: c.value for k, c in self.counters.items()},
            "gauges": {k: g.as_dict() for k, g in self.gauges.items()},
            "histograms": {k: {"samples": list(h.samples)} for k, h in self.histograms.items()},
            "spans": self.span_stats(),
        }

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another process's :meth:`snapshot` into this registry."""
        for k, v in (snap.get("counters") or {}).items():
            self.counter(k).add(v)
        for k, d in (snap.get("gauges") or {}).items():
            g = self.gauge(k)
            for key in ("min", "last", "max"):  # keeps the merged min and max
                if d.get(key) is not None:
                    g.set(d[key])
        for k, d in (snap.get("histograms") or {}).items():
            h = self.histogram(k)
            for v in d.get("samples") or ():
                h.record(v)


_CURRENT: List[Telemetry] = [Telemetry()]


def get_telemetry() -> Telemetry:
    """The active registry: the process-wide one unless :func:`use` pushed another."""
    return _CURRENT[-1]


@contextmanager
def use(tel: Telemetry) -> Iterator[Telemetry]:
    """Make ``tel`` the active registry for the block."""
    _CURRENT.append(tel)
    try:
        yield tel
    finally:
        _CURRENT.pop()


def reset_telemetry() -> None:
    """Zero the active registry in place."""
    get_telemetry().reset()
