"""The control fails the check: the plain reference in the precision below
the configuration's (TF32 for the SLAM's float32, float8 for the network's
bfloat16), put in the program's place, reads outside the cell's limits.
Needs the card, where TF32 exists; one seed a cell at the cell's own size
(two sampled scans for the network). The readings on three seeds a cell are
``suma_bench.control``'s."""

import pytest

from suma_bench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cuda_device, cell):
    limits = harness.cell(cell)["limits"]
    numbers = control.control_numbers(
        cell, 2**31 + 101, cuda_device,
        overrides={"traffic": {"check_scans": 2}})
    assert any(numbers[k] > limits[k] for k in numbers), numbers
