"""chain_ms_per_iter (ms): the chain phase of the fits (``time["mcmc"]``,
``run_mcmc``'s clock after a device synchronisation) an iteration, over the
jobs the profiler did not slow."""


def read(ctx):
    js = [j for j in ctx.untraced if "mcmc" in j.time]
    if not js:
        return None
    return 1e3 * sum(j.time["mcmc"] for j in js) / sum(j.iters for j in js)
