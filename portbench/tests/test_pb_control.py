"""The control, the reference a precision lower put in the program's place,
comes out not correct in every cell, while the program passes (small sizes
on the CPU; `calibrate.py` reads both at the cells' own sizes on the card)."""
import pytest
import torch

from portbench.calibrate import readings
from portbench.lib.cell import cell_spec
from portbench.tests import tiny


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_and_program_passes(cell):
    limits = cell_spec(cell)["limits"]
    got = readings(cell, [21, 22], 2, torch.device("cpu"), tiny.overrides(cell),
                   out=lambda s: None)
    for name, values in got["program"].items():
        assert max(values) <= limits[name], (name, values)
    for i in range(2):
        assert any(got["control"][name][i] > limits[name] for name in limits), got["control"]
