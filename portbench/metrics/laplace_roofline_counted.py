"""laplace_roofline_counted (%): K1, ``laplace_solve_kernel``, least time
over its device time in the traced fit, with the rows and the passes the
program counted in that fit (``laplace.rows``, ``laplace.passes``), every
proposal's included: the work the kernel did, where ``laplace_roofline``
samples it from the reference's passes at the heads."""
import torch

from portbench import program
from portbench.counts import ops


def read(ctx):
    rows = program.counter(ctx, "laplace.rows")
    passes = program.counter(ctx, "laplace.passes")
    t = ctx.trace.device_s("laplace_solve_kernel") if ctx.trace else 0.0
    if not rows or not passes or t <= 0:
        return None
    cfg, mix = ctx.cell.config, ctx.cell.mix
    ent = mix.get("run") or mix["call"]
    b = ops.bounds(rows, cfg["n"], cfg["m"], int(ent["particles"]),
                   getattr(torch, cfg["dtype"]), passes)["laplace_solve"]
    return 100.0 * b["bound_ms"] * 1e-3 / t
