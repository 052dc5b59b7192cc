"""laplace_passes_per_row (passes): the Laplace passes of the traced fit
over the rows it sent to a Laplace solve, both counted by the program
(``laplace.passes``, which the ``laplace_solve`` kernel adds to on the
card, and ``laplace.rows``; ``portbench/program.py``)."""
from portbench import program


def read(ctx):
    rows = program.counter(ctx, "laplace.rows")
    passes = program.counter(ctx, "laplace.passes")
    if not rows or passes is None:
        return None
    return passes / rows
