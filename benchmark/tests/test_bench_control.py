"""The control of each cell, at a tiny size on the CPU: the reference put
in the program's place and computed in float8 (e4m3 operands for every
convolution, one scale a tensor), held against the float32 reference,
has to fail at least one of the cell's limits. At the cells' own sizes on
the card: ``python3 -m benchmark.calibrate --workload <cell>
--control-seeds ...`` (PERF.md lists the readings)."""

import pytest
import torch

from benchmark import calibrate

from . import tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    parts = tiny.parts(cell)
    limits = parts["workload"]["limits"]
    numbers = calibrate.control(parts, 2**31 + 99, torch.device("cpu"))
    assert set(limits) <= set(numbers)
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)
