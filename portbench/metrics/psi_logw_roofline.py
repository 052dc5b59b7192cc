"""psi_logw_roofline (%): K3, ``psi_logw_kernel``, least time over its
device time in the traced fit (``counts/work.py``)."""
from portbench.counts import work


def read(ctx):
    return work.roofline(ctx, "psi_logw_kernel")
