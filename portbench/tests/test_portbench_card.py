"""On the card: one short run of each cell prints a result line of the
contract's form, and it is correct.  Skipped without a CUDA device."""
import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = ["poisson_llt.is2_psi_N10", "svm_exchange.is2_psi_N64"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "4000000001", "--seconds", "1", "--trace", "0"],
        cwd=str(harness.ROOT), capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"]
