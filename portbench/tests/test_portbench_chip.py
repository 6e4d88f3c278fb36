"""On the card, at each cell's own size: the program's readings pass the cell's
limits and the control's (the reference in float8 e4m3 in the program's
place) do not, nor, on the training cell, half of the batch left out.
Skips without a card; run there with
``python3 -m pytest -q portbench/tests/test_portbench_chip.py``."""

import pytest

from portbench import control, harness

pytestmark = pytest.mark.portbench_chip
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    run = harness.Run(cell, 2 ** 31 + 99, 0.0, False, device=card)
    limits = run.workload["check"]["limits"]
    if run.workload["entry"] == "train_step":
        out = control.train_readings(run, True)
        faults = ("control", "half_batch")
    else:
        out = control.prefill_readings(run, True)
        faults = ("control",)
    numbers = [k for k in out["program"] if k in limits]
    assert all(out["program"][k] <= limits[k] for k in numbers), out
    for fault in faults:
        assert any(out[fault][k] > limits[k] for k in numbers), (fault, out)
