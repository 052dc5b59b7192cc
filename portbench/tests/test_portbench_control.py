"""The control, the reference itself put in the program's place in
bfloat16 (the precision below the configurations' float32), fails one of
each cell's numbers under the limits of ``limits/<cell>.json``: here at a
tiny size on the CPU, on three seeds; at the cells' own sizes on the card
with ``python3 -m portbench.readings`` (PERF.md gives its readings)."""
import pytest
import torch

from portbench import harness, readings

CELLS = ["poisson_llt.is2_psi_N10", "svm_exchange.is2_psi_N64"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(cell, tiny):
    limits = harness.load_cell(cell).limits
    seeds = [2 ** 31 + 11, 5, 77]
    out = readings.readings(cell, 0.0, [], seeds, torch.device("cpu"),
                            dict(tiny, limits={}), emit=lambda s: None)
    failed = [k for k, v in out["control_lowest"].items()
              if k in limits and not v <= limits[k]]
    assert failed, (out["control_lowest"], limits)
