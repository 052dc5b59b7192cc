"""host_copy_ms (ms): the program's ``bssm.fit.host_copy`` span in the
traced fit: ``McmcOutput``'s host arrays of the chain, copied after the
chain's synchronisation (``portbench/program.py``)."""
from portbench import program


def read(ctx):
    s = program.span_s(ctx, "bssm.fit.host_copy")
    return None if s is None else 1e3 * s
