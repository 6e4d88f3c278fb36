"""``kernels._build`` without a CUDA compiler.

A stand-in ``nvcc`` (a Python script that sleeps, writes its output file
and prints a ``ptxas``-style line) shows that :func:`build_all` runs one
compiler per source, all at once; that a built library is reused; that
each library's name hashes its own source and the shared headers; and
that a failed compile raises with the compiler's output.
"""

import sys
import time

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
if "bad" in args[-1]:
    print("bad.cu(1): error: no such thing")
    sys.exit(2)
time.sleep(1.0)
with open(args[args.index("-o") + 1], "w") as f:
    f.write(args[-1])
print("ptxas info    : Used 32 registers, used 1 barriers, for " + args[-1])
"""
NAMES = ("one", "two", "three", "four")


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in NAMES:
        (csrc / f"{name}.cu").write_text(f'// {name}\n#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_build_all_runs_one_compiler_per_source_at_once(fake_tree):
    t0 = time.perf_counter()
    built = _build.build_all()
    elapsed = time.perf_counter() - t0
    assert sorted(built) == sorted(NAMES)
    assert elapsed < 3.0  # four 1 s compiles side by side, not 4 s in turn
    for name, b in built.items():
        assert b.path.exists() and b.path.name.startswith(f"{name}-")
        assert b.seconds >= 1.0 and "Used 32 registers" in b.ptxas
    again = _build.build_all()  # built already: reused, nothing runs
    assert all(b.seconds == 0.0 and b.path == built[name].path for name, b in again.items())
    (fake_tree / "shared.cuh").write_text("// v2\n")  # a shared header rebuilds every library
    assert all(_build._target(name) != built[name].path for name in NAMES)
    (fake_tree / "shared.cuh").write_text("// v1\n")
    (fake_tree / "one.cu").write_text("// edited\n")  # a source rebuilds its own library only
    assert _build._target("one") != built["one"].path
    assert _build._target("two") == built["two"].path


def test_build_all_raises_with_the_compiler_output(fake_tree):
    (fake_tree / "bad.cu").write_text("// broken\n")
    with pytest.raises(RuntimeError, match="kernel build of bad failed") as err:
        _build.build_all()
    assert "no such thing" in str(err.value)
    assert all(_build._target(name).exists() for name in NAMES)  # the others finished first
