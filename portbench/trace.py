"""The reduction of a profiler trace to what the per-layer metrics read.

:func:`summarise` takes the events ``torch.profiler`` recorded around the
window (the CPU range ``portbench.window`` bounds it) and keeps, on one
time base in nanoseconds:

* the device operations (kernels, copies, sets) clipped to the window;
* the program's ranges as they show on the device timeline (``moe.*``,
  ``model.*``) and the host's ranges and operators;
* ``busy_ns``: the union of the device operations' intervals, so that
  two operations that overlap count once, against ``window_ns``, the
  wall time of the same stretch: the host range ``portbench.window``
  where the host's operators were recorded, else the span from the first
  device operation's start to the last one's end (a window traced with
  the device's activities alone, which keep the profiler's overhead off
  the host);
* the device time by name, and the longest idle gaps labelled by the
  innermost host range or operator open at each gap's start.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
RANGE_PREFIXES = ("moe.", "model.", "portbench.")
NAME_CHARS = 160

Interval = Tuple[int, int]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in union(intervals))


def overlap(ops: Sequence[Tuple[str, int, int]], ranges: Sequence[Interval]) -> int:
    """Nanoseconds of ``ops`` that lie inside the union of ``ranges``."""
    merged = union(ranges)
    starts = [s for s, _ in merged]
    total = 0
    for _, s, e in ops:
        j = max(0, bisect.bisect_right(starts, s) - 1)
        while j < len(merged) and merged[j][0] < e:
            total += max(0, min(e, merged[j][1]) - max(s, merged[j][0]))
            j += 1
    return total


@dataclass
class Summary:
    window: Interval
    ops: List[Tuple[str, int, int]]  # device operations (name, start, end), clipped to the window
    device_ranges: List[Tuple[str, int, int]]  # the program's ranges on the device timeline
    host: List[Tuple[str, int, int]] = field(default_factory=list)  # host ranges and operators

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    @property
    def busy_ns(self) -> int:
        return covered([(s, e) for _, s, e in self.ops])

    def by_name(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0) + (e - s)
        return out

    def time_in_ranges(self, prefix: str) -> Optional[int]:
        """Device ns inside the program's ranges named ``prefix*``; None if none was recorded."""
        ranges = [(s, e) for n, s, e in self.device_ranges if n.startswith(prefix)]
        return overlap(self.ops, ranges) if ranges else None

    def gaps(self, top: int = 10) -> List[Tuple[str, int]]:
        """The ``top`` longest idle stretches of the device inside the window,
        each named by what the host was doing when it began."""
        busy = union([(s, e) for _, s, e in self.ops])
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        idle.sort(key=lambda iv: iv[0] - iv[1])
        hosts = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        out = []
        for s, e in idle[:top]:
            j = bisect.bisect_right(starts, s)
            best = None
            for name, hs, he in hosts[max(0, j - 2000):j]:  # innermost: the latest start that still covers s
                if he >= s and name != WINDOW:
                    best = name
            out.append((f"host in {best}" if best else "host outside any range", e - s))
        return out

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time and the ten longest
        idle gaps, in seconds; names cut to :data:`NAME_CHARS`."""
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in self.gaps()]}


def _is_annotation(e) -> bool:
    try:
        if e.is_user_annotation():
            return True
    except AttributeError:
        pass
    return e.name().startswith(RANGE_PREFIXES)


def summarise(prof) -> Optional[Summary]:
    """A :class:`Summary` of the events ``prof`` recorded; None if it holds no device operation."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = None
    ops, ranges, host = [], [], []
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        name = e.name()
        if e.device_type() == cuda:
            (ranges if _is_annotation(e) else ops).append((name, s, t))
        else:
            if name == WINDOW:
                window = (s, t)
            host.append((name, s, t))
    if window is None:
        if not ops:
            return None
        window = (min(s for _, s, _ in ops), max(t for _, _, t in ops))
    w0, w1 = window
    ops = [(n, max(s, w0), min(t, w1)) for n, s, t in ops if t > w0 and s < w1]
    return Summary(window=window, ops=ops, device_ranges=ranges, host=host)
