"""device_ops_per_iter (ops): the device operations (kernels, copies, fills)
in the profiler's trace of one whole fit, an iteration: a count, which a
change in how the host issues work moves."""


def read(ctx):
    if ctx.trace is None or ctx.traced is None:
        return None
    return ctx.trace.n_device_ops / ctx.traced.iters
