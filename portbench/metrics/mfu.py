"""mfu (%): the counted operations of every kernel of the traced job
over its window and the float32 peak (``counts/work.py``)."""
from portbench.counts import work


def read(ctx):
    return work.mfu(ctx)
