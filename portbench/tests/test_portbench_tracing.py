"""The readers of the program's record (``portbench/program.py``): from a
traced tiny run of each cell on the CPU, ``laplace_passes_per_row``,
``laplace_roofline_counted`` and ``host_copy_ms`` (and their ``.sv``
copies) read finite numbers, and None where the program kept no record of
the traced fit.  The CPU's trace holds no kernel, so K1's device time is
put into it by hand for the roofline."""
import math

import pytest
import torch

from portbench import harness

CELLS = {"poisson_llt.is2_psi_N10": "", "svm_exchange.is2_psi_N64": ".sv"}
READERS = ["laplace_passes_per_row", "laplace_roofline_counted",
           "host_copy_ms"]
SEED = 2 ** 31 + 19
# fewer chains and iterations than the other tests' tiny size: on the CPU
# every Laplace pass is a loop of small operations, each an event of the
# profiler's trace
FEW = {"n_chains": 8, "iter": 12}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_readers_of_the_program_record(cell, tiny):
    shrink = dict(tiny, mix=dict(tiny["mix"], warmup_iter=2,
                                 run=dict(tiny["mix"]["run"], **FEW)))
    p = harness.prepare(cell, SEED, torch.device("cpu"), shrink)
    w = harness.measure(p, SEED, 0.0, True)
    ctx = harness.Context(p.cell, w.jobs, w.traced, w.tracer.summary(),
                          None)
    names = [harness.reader(r + CELLS[cell]) for r in READERS]
    assert {r + CELLS[cell] for r in READERS} <= {
        m["name"] for m in ctx.cell.per_layer}
    by_name = dict(ctx.trace.device_s_by_name, laplace_solve_kernel=0.5)
    k1 = ctx._replace(trace=ctx.trace._replace(device_s_by_name=by_name))
    for name, read in zip(READERS, names):
        v = read(k1)
        assert v is not None and math.isfinite(v) and v > 0, (name, v)
    assert 1.0 <= names[0](ctx) <= 100.0     # passes a row
    assert names[1](ctx) is None             # no kernel in the trace
    other = ctx._replace(traced=ctx.traced._replace(seed=SEED + 1))
    untraced = ctx._replace(traced=None, trace=None)
    for read in names:
        assert read(other) is None and read(untraced) is None
