"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface
(``build/kernels/<name>-<hash>.so`` at the root of the checkout), loaded
with ``ctypes``.  The file name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and
a built one is reused.  Nothing is built when a module is imported: only
a launch on a CUDA tensor, or an explicit :func:`build_all`, calls
``nvcc``.  :func:`build_all` starts one ``nvcc`` per source, all together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple

from repro_torch.telemetry import WALL

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Built(NamedTuple):
    """One library: where it is, the seconds its build took (0.0 if it was
    built already) and what ``ptxas -v`` said (registers, shared memory,
    spills per kernel; empty if it was built already)."""

    path: Path
    seconds: float
    ptxas: str


def sources() -> list:
    """The names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, Built]:
    """Build every source in ``names`` (default: all of ``csrc/*.cu``) that
    is not built yet, one ``nvcc`` process per source, all started at once.

    Raises with the compiler's output when any build fails; the other
    builds are waited for first, so no process outlives the call.
    """
    names = sources() if names is None else list(names)
    out, running = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = Built(target, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, target, tmp, WALL.now())
    failed = []
    for name, (proc, target, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = (WALL.now() - t0) / 1e6
        if proc.returncode != 0:
            failed.append(f"kernel build of {name} failed (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = Built(target, seconds, log.strip())
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` unless it is built already; return the library."""
    return build_all([name])[name].path


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    return ctypes.CDLL(str(build(name)))
