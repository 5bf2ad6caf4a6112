"""The control of the comparison, the reference computed in TF32 (every
matrix product's operands rounded) in the program's place, comes out
beyond every cell's limits, and a sound run within them, at a size a
test run holds (the readings at the cells' own sizes are control.py's,
on the card; PERF.md)."""

import pytest
import torch

from benchmark.control import readings
from benchmark.reference.compare import judge
from benchmark.tests.tiny import CELLS, SEED, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    torch.set_num_threads(2)
    cell = tiny_cell(name)
    cpu = torch.device("cpu")
    sound = judge(readings(cell, "sound", SEED, cpu), cell.limits)
    assert all(c["ok"] for c in sound), sound
    control = judge(readings(cell, "control", SEED, cpu), cell.limits)
    assert not all(c["ok"] for c in control), control
