"""laplace_roofline (%): K1, ``laplace_solve_kernel``, least time over its
device time in the traced fit; the operations from the reference's sampled
Laplace passes (``counts/work.py``)."""
from portbench.counts import work


def read(ctx):
    return work.roofline(ctx, "laplace_solve_kernel")
