"""device_idle_share (%): the share of the traced window in which no
device operation ran (the union of their intervals)."""
from portbench.counts import work


def read(ctx):
    return work.idle_share(ctx)
