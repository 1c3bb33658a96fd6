"""The control comes out not correct: the plain reference in float32 with
TF32 products (the nearest precision below the configurations' float32)
put in the program's place, at each cell's own size, on three seeds, for
every cell whose files are ready. Needs the card: TF32 exists only there
(about a minute). ``python3 portbench/calibrate.py`` prints the same
readings (README.md)."""

import pytest
import torch

import small
from portbench.lib import harness
from portbench.reference.codec import Reference


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(small.SIZES))
def test_control_fails_every_cell(name):
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need the card")
    cell = harness.Cell(name)
    limit = cell.workload["limits"]["err"]
    for seed in (1, 2, 3):
        run = harness.Run(cell, seed, 30.0, False, "cuda", "", 0.0)
        control = Reference(cell.config, "cuda", torch.float32, tf32=True)
        assert cell.traffic().control(run, control) > limit
