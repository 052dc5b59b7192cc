"""A run of each cell, on the CPU at a tiny size and without the look for a
card, with the timed path broken underneath (``portbench/faults.py``):
``correct`` comes out false for each fault the cell can have, under the
cell's own limits of ``limits/<cell>.json``, by a number that the sound
tiny run keeps inside those limits; and the sound run is correct under the
tiny size's limits.  The same faults at the cells' own sizes on the card:
``python3 -m portbench.readings --fault-seeds`` (PERF.md gives the
readings)."""
import time

import pytest
import torch

from portbench import harness
from portbench.faults import FAULTS

CELLS = ["poisson_llt.is2_psi_N10", "svm_exchange.is2_psi_N64"]
_SOUND = {}


def _run(cell, shrink, fault=None):
    return harness.run(cell, 2 ** 31 + 7, 0.0, False, torch.device("cpu"),
                       time.time(), fault=fault, emit=lambda s: None,
                       shrink=shrink)


def _passing(result):
    return {k for k, c in result["checks"].items()
            if c["value"] <= c["limit"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    r = _run(cell, tiny)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS])
def test_fault_is_caught_under_the_cells_limits(cell, fault, tiny):
    own = dict(tiny, limits={})             # the cell's own limits
    if cell not in _SOUND:
        _SOUND[cell] = _run(cell, own)
    r = _run(cell, own, FAULTS[fault]())
    assert not r["correct"], r["checks"]
    caught = _passing(_SOUND[cell]) - _passing(r)
    assert caught, (r["checks"], _SOUND[cell]["checks"])
