"""Command line: ``python -m repro_torch.analysis [--fast] [--no-trace] [--device cpu|cuda]``.

Runs the kernel checker over every registered contract and exits 1 if any
rule fires.  It prints the number of contracts proven and the number of
kernel launches the run made (``repro_torch.kernels.WRAPPERS``' counts):
none on the CPU, where the wrappers take their plain versions, and every
trace point's on the card.  Without a card and without ``--device cpu``
it raises: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description="Contract checker for the port's Merge Path kernels.")
    ap.add_argument("--fast", action="store_true", help="shrink the trace lattice (the test suite's mode)")
    ap.add_argument("--no-trace", action="store_true", help="the closed-form rules only: run no wrapper")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="where the wrappers run (default: the card)")
    args = ap.parse_args(argv)

    from repro_torch.kernels import WRAPPERS, reset_launches
    from repro_torch.telemetry import wall_seconds

    from . import check_kernels, registered_contracts

    reset_launches()
    t0 = wall_seconds()
    violations = check_kernels(fast=args.fast, trace=not args.no_trace, device=args.device)
    dt = wall_seconds() - t0
    n = len(registered_contracts())
    launches = sum(fn.launches for fn in WRAPPERS)
    if violations:
        for v in violations:
            print(f"analysis: {v}", file=sys.stderr)
        print(f"analysis: FAIL ({len(violations)} violations across {n} contracts, {dt:.1f}s, "
              f"{launches} kernel launches)", file=sys.stderr)
        return 1
    print(f"analysis: OK ({n} contracts proven on the lattice, {dt:.1f}s, {launches} kernel launches)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
