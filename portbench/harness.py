"""The benchmark's driver: one cell, one seed, one window, one result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name.  ``BENCHMARK.json`` names the cell; the cell's
file ``portbench/workloads/<cell>.json`` names its configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<mix>.json``, read by the generator
``portbench/traffic/<generator>.py``) and its entry point
(``portbench/entries/<entry>.py``), which sets up, runs the window and
checks what the window produced.  Each metric is read by
``portbench/metrics/<metric>.py``; with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.  A new cell,
configuration, mix or metric is new files and new entries of
``BENCHMARK.json``: no file here changes.

The run refuses, with no result line and a code other than 0, where there
is no CUDA device or fewer than the cell asks for, and where JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
KINDS = ("configs", "workloads", "traffic", "metrics", "entries")


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden import, a bad manifest)."""


def clock() -> float:
    return time.perf_counter()


def process_start() -> float:
    """The process's start on :func:`clock`'s scale, from ``/proc`` where it
    is there, else the import of this module."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return clock() - max(0.0, up - start)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = clock()


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"no {path}")
    return load_json(path)


def find(kind: str, name: str, suffix: str = ".json", root: Path = ROOT) -> Path:
    """The file of ``name`` among ``kind`` (one of :data:`KINDS`)."""
    if kind not in KINDS or not NAME_RE.match(name):
        raise Refused(f"bad {kind} name {name!r}")
    path = root / "portbench" / kind / f"{name}{suffix}"
    if not path.exists():
        raise Refused(f"no {kind} file for {name!r}: {path}")
    return path


def module(kind: str, name: str, root: Path = ROOT):
    """The module ``portbench/<kind>/<name>.py``, loaded from its path (a
    metric's name may hold dots)."""
    path = find(kind, name, ".py", root)
    key = f"portbench.{kind}._" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def check_manifest(m: Dict) -> List[str]:
    """What in ``m`` breaks the names and units rules."""
    bad = []
    names = [c["name"] for c in m.get("configs", [])] + [w["name"] for w in m.get("workloads", [])]
    metrics = m.get("end_to_end", []) + m.get("per_layer", [])
    names += [x["name"] for x in metrics]
    names += [w["config"] for w in m.get("workloads", [])] + [w["traffic"] for w in m.get("workloads", [])]
    names += [k for c in m.get("configs", []) for k in c.get("reduced", [])]
    bad += [f"name {n!r}" for n in names if not NAME_RE.match(str(n))]
    bad += [f"unit {x['unit']!r} of {x['name']}" for x in metrics if not UNIT_RE.match(x.get("unit", ""))]
    bad += [f"better {x['better']!r} of {x['name']}" for x in metrics if x.get("better") not in ("lower", "higher")]
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in m.get(group, [])]
        bad += [f"{group} {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    seen = [x["name"] for x in metrics]
    bad += [f"metric {n!r} twice" for n in set(seen) if seen.count(n) > 1]
    return bad


def cell_metrics(m: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: end-to-end with ``trace`` off,
    per-layer with it on; an entry without ``workloads`` applies to every
    cell (a per-layer one to every cell that reports its ``moves``)."""
    e2e = [x for x in m["end_to_end"] if cell in x.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {x["name"] for x in e2e}
    return [x for x in m["per_layer"] if cell in x.get("workloads", [cell] if x["moves"] in names else [])]


class Run:
    """What one run knows and what its entry point records.

    The entry point sets ``setup_s``, ``attempted``, ``failed``,
    ``memory_peak_bytes``, ``records`` (its own), ``trace_summary`` (a
    :class:`portbench.trace.Summary` or None) and ``checks``: ``(name,
    value, limit)`` triples, each passing while ``value <= limit``.
    ``wrap`` lets a test put a broken program in place of the real one.
    """

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
                 root: Path = ROOT, overrides: Optional[Dict] = None, t_start: Optional[float] = None):
        self.cell, self.seed, self.seconds, self.trace, self.device = cell, seed, seconds, trace, device
        self.root = root
        self.t_start = process_start() if t_start is None else t_start
        self.manifest = manifest(root)
        entry = next((w for w in self.manifest["workloads"] if w["name"] == cell), None)
        if entry is None:
            raise Refused(f"no workload {cell!r} in BENCHMARK.json")
        self.chips = entry["chips"]
        self.workload = load_json(find("workloads", cell, root=root))
        self.config = load_json(find("configs", entry["config"], root=root))
        self.mix = load_json(find("traffic", entry["traffic"], root=root))
        for key, value in (overrides or {}).items():  # tests: tiny sizes on the CPU
            getattr(self, key).update(value)
        self.wrap = lambda name, fn: fn
        self.setup_s = 0.0
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.records: Dict[str, Any] = {}
        self.trace_summary = None
        self.checks: List[tuple] = []

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v == v and v <= lim for _, v, lim in self.checks)


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card and has no fallback")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} present")


def card(run: Run) -> None:
    """The card's name and power limit into ``run.records`` (``nvidia-smi``, where it is there)."""
    import subprocess

    import torch

    run.records["device_kind"] = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        run.records["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        run.records["power_limit_w"] = None


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def execute(run: Run) -> Dict:
    """Run ``run``'s entry point and read its metrics: the result line's object."""
    entry = module("entries", run.workload["entry"], run.root)
    entry.run(run)
    metrics = {}
    for x in cell_metrics(run.manifest, run.cell, run.trace):
        value = module("metrics", x["name"], run.root).read(run)
        if value is not None:
            metrics[x["name"]] = {"value": value, "unit": x["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device, "kind": run.records.get("device_kind", ""),
              "count": run.chips, "memory_peak_bytes": run.memory_peak_bytes,
              "power_limit_w": run.records.get("power_limit_w")}
    if run.trace:
        device["busy_s"] = run.trace_summary.busy_ns / 1e9 if run.trace_summary else 0.0
        device["window_s"] = run.trace_summary.window_ns / 1e9 if run.trace_summary else 0.0
    out = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": device}
    if run.trace and run.trace_summary is not None:
        out["breakdown"] = run.trace_summary.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.checks}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        run = Run(a.workload, a.seed, a.seconds, bool(a.trace))
        bad = check_manifest(run.manifest)
        if bad:
            raise Refused("BENCHMARK.json: " + "; ".join(bad))
        require_card(run.chips)
        out = execute(run)
        found = forbidden_modules()  # in the process that prints the result, once the window has closed
        if found:
            raise Refused(f"modules loaded that the port may not load: {found}")
    except Refused as e:
        print(f"portbench: refused: {e}", file=sys.stderr)
        return 2
    check_s = run.records.get("check_s", 0.0)
    print(f"portbench: setup {run.setup_s:.1f} s, window {run.seconds} s, check {check_s:.1f} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
