"""particle_big_roofline (%): K4, ``particle_big_kernel`` in psi mode,
least time over its device time in the traced job (``counts/work.py``)."""
from portbench.counts import work


def read(ctx):
    return work.roofline(ctx, "particle_big_kernel")
