"""correction_us_per_head (us): the IS correction's seconds (the
output's ``time["correction"]``, after a device synchronisation) a head
corrected, over the jobs the profiler did not slow."""


def read(ctx):
    js = [j for j in ctx.untraced if j.n_corrected]
    if not js:
        return None
    return 1e6 * sum(j.time["correction"] for j in js) / sum(
        j.n_corrected for j in js)
