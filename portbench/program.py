"""What the program records of the traced job: the record of its fit that
``bssm_tpu_torch.diagnostics.profiling`` keeps while the profiler runs (its
spans and the change of its counters), found by the job's seed.  A program
that keeps no such record gives None, and the metrics that read one are
left out of the result's line."""
from __future__ import annotations


def record(ctx):
    """The program's record of ``ctx.traced``'s fit, or None."""
    job = ctx.traced
    if job is None:
        return None
    try:
        from bssm_tpu_torch.diagnostics import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    if records is None:
        return None
    for rec in reversed(records()):
        if rec.seed == job.seed:
            return rec
    return None


def counter(ctx, name: str):
    """The change of the program's counter ``name`` over the traced fit, or
    None."""
    rec = record(ctx)
    return None if rec is None else rec.counters.get(name)


def span_s(ctx, name: str):
    """Seconds in the program's spans ``name`` of the traced fit (host
    clock), or None where it has none."""
    rec = record(ctx)
    if rec is None:
        return None
    ns = [s.end_ns - s.start_ns for s in rec.spans if s.name == name]
    return sum(ns) * 1e-9 if ns else None
