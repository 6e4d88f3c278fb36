"""Trace-file CLI: summarize, check, or diff Perfetto traces.

The port's copy of the reference's ``python -m repro.telemetry``::

    python -m repro_torch.telemetry trace.json              # summarize
    python -m repro_torch.telemetry trace.json other.json   # diff two traces
    python -m repro_torch.telemetry --check trace.json      # gate

``--check`` exits nonzero if the trace has unclosed spans or the
Corollary 7 window balance ratio gauge exceeds ``--max-balance`` (default
1.05).  A trace without the balance gauge passes the balance check with
a note.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .export import load_trace


def _other(trace: dict) -> dict:
    return trace.get("otherData") or {}


def _fmt_num(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def summarize(trace: dict) -> List[str]:
    other = _other(trace)
    lines = [
        f"clock={other.get('clock', '?')}  "
        f"events={len(trace.get('traceEvents') or [])}  "
        f"unclosed_spans={other.get('unclosed_spans', '?')}"
    ]
    spans = other.get("spans") or {}
    if spans:
        lines.append("spans:")
        for name in sorted(spans):
            rec = spans[name]
            lines.append(
                f"  {name:<40s} count={rec.get('count', 0):<8d} "
                f"total_us={_fmt_num(rec.get('total_us', 0))}"
            )
    counters = other.get("counters") or {}
    if counters:
        lines.append("counters:")
        for name in sorted(counters):
            lines.append(f"  {name:<40s} {_fmt_num(counters[name])}")
    gauges = other.get("gauges") or {}
    if gauges:
        lines.append("gauges:")
        for name in sorted(gauges):
            g = gauges[name]
            lines.append(
                f"  {name:<40s} last={_fmt_num(g.get('last'))} "
                f"min={_fmt_num(g.get('min'))} max={_fmt_num(g.get('max'))}"
            )
    health = other.get("health") or {}
    if health:
        lines.append("health:")
        for op in sorted(health):
            h = health[op]
            lines.append(
                f"  {op:<40s} calls={h.get('calls', 0)} "
                f"fallbacks={h.get('fallbacks', 0)} "
                f"failures={h.get('failures', 0)}"
            )
    return lines


def check(trace: dict, max_balance: float) -> List[str]:
    """Return a list of failure messages (empty → trace is healthy)."""
    other = _other(trace)
    problems = []
    unclosed = other.get("unclosed_spans")
    if unclosed is None:
        problems.append("trace has no otherData.unclosed_spans field")
    elif unclosed != 0:
        problems.append(f"{unclosed} unclosed span(s)")
    balance = (other.get("gauges") or {}).get("distributed.balance_ratio")
    if balance is not None and balance.get("max") is not None:
        if balance["max"] > max_balance:
            problems.append(
                f"window balance ratio {balance['max']:.4f} exceeds "
                f"{max_balance:.4f} (Cor. 7 violated)"
            )
    return problems


def diff(a: dict, b: dict) -> List[str]:
    """Line diff of counters/gauges/span counts between two traces."""
    oa, ob = _other(a), _other(b)
    lines = []

    ca, cb = oa.get("counters") or {}, ob.get("counters") or {}
    for name in sorted(set(ca) | set(cb)):
        va, vb = ca.get(name), cb.get(name)
        if va != vb:
            lines.append(f"counter {name}: {_fmt_num(va)} -> {_fmt_num(vb)}")

    ga, gb = oa.get("gauges") or {}, ob.get("gauges") or {}
    for name in sorted(set(ga) | set(gb)):
        la = (ga.get(name) or {}).get("last")
        lb = (gb.get(name) or {}).get("last")
        if la != lb:
            lines.append(f"gauge {name}: {_fmt_num(la)} -> {_fmt_num(lb)}")

    sa, sb = oa.get("spans") or {}, ob.get("spans") or {}
    for name in sorted(set(sa) | set(sb)):
        na = (sa.get(name) or {}).get("count", 0)
        nb = (sb.get(name) or {}).get("count", 0)
        if na != nb:
            lines.append(f"span {name}: count {na} -> {nb}")

    if not lines:
        lines.append("traces agree on counters, gauges, and span counts")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry",
        description="Summarize, check, or diff Perfetto trace files.",
    )
    ap.add_argument("trace", help="trace JSON file (from telemetry.write_trace)")
    ap.add_argument("other", nargs="?", help="second trace: diff mode")
    ap.add_argument(
        "--check",
        action="store_true",
        help="exit nonzero on unclosed spans or balance-ratio violations",
    )
    ap.add_argument(
        "--max-balance",
        type=float,
        default=1.05,
        help="max allowed distributed.balance_ratio (default 1.05)",
    )
    args = ap.parse_args(argv)

    trace = load_trace(args.trace)

    if args.other is not None:
        for line in diff(trace, load_trace(args.other)):
            print(line)
        return 0

    if args.check:
        problems = check(trace, args.max_balance)
        if problems:
            for p in problems:
                print(f"FAIL: {p}")
            return 1
        balance = (_other(trace).get("gauges") or {}).get("distributed.balance_ratio")
        note = (
            f"balance_ratio max={balance['max']:.4f}"
            if balance is not None and balance.get("max") is not None
            else "balance_ratio gauge absent (no distributed ops in trace)"
        )
        print(f"OK: 0 unclosed spans; {note}")
        return 0

    for line in summarize(trace):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
