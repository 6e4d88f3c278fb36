"""The benchmark's tests: the harness, the counts and the reference on the CPU
at tiny sizes; the control on the card (marker ``portbench_chip``), which
skips here."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "portbench_chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the card at the cell's size")
    return "cuda"
