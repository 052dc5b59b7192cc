"""The kernel work of a traced job, from its shapes: which kernels its
entry launches and how many rows each takes, with the operations and bytes
of ``ops.py`` and the least time each could take on the card.

A fit (``run_mcmc``, is2, psi) evaluates every chain's proposal with one
Laplace solve (K1) an iteration and once at the start; without stored
modes its correction solves again at each head; then the proposal factors
(K2) and the psi filter, ``psi_logw`` (K3) up to 32 particles, the
large-ensemble kernel (K4) above, at each head.  ``post_correct`` runs K2
and K4 (or K3) at each head, from the stored modes.  The Laplace passes a
row needs depend on the data; ``passes`` is the reference's mean at the
sampled heads (to the program's float32 tolerance), so K1's count is
sampled, not counted.
"""
from __future__ import annotations

import torch

from portbench.counts import ops

# the psi_logw kernel's largest particle count; above it K4 runs
MAX_N_PSI = 32


def _dtype(cfg: dict):
    return getattr(torch, cfg["dtype"])


def kernels(ctx) -> dict:
    """``{kernel name in the trace: its ops.roofline dict}`` of the traced
    job, or {} without one."""
    job = ctx.traced
    if job is None:
        return {}
    cfg, mix = ctx.cell.config, ctx.cell.mix
    n, m, dt = cfg["n"], cfg["m"], _dtype(cfg)
    ent = mix.get("run") or mix["call"]
    N, kk = int(ent["particles"]), int(ent.get("psi_resample_every", 1))
    heads = job.n_corrected
    out = {}
    b = ops.bounds(heads, n, m, N, dt, 0.0)
    out["rts_factors_kernel"] = b["rts_factors"]
    if N <= MAX_N_PSI:
        out["psi_logw_kernel"] = b["psi_logw"]
    else:
        out["particle_big_kernel"] = ops.big_bounds(heads, n, n, m, N, kk,
                                                    dt, psi=True)
    if mix["entry"] == "fit" and ctx.passes_mean is not None:
        rows = (int(ent["iter"]) + 1) * int(ent["n_chains"])
        if not ent.get("store_modes", True):
            rows += heads
        out["laplace_solve_kernel"] = ops.bounds(
            rows, n, m, N, dt, ctx.passes_mean * rows)["laplace_solve"]
    return out


def roofline(ctx, kernel: str):
    """Percent of ``kernel``'s roofline in the traced job: its least time
    over its device time; None where the trace shows none of it."""
    if ctx.trace is None:
        return None
    b = kernels(ctx).get(kernel)
    t = ctx.trace.device_s(kernel)
    if b is None or t <= 0:
        return None
    return 100.0 * b["bound_ms"] * 1e-3 / t


def mfu(ctx):
    """Percent of the float32 peak that the traced job's counted operations
    make of its window."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    ks = kernels(ctx)
    if not ks:
        return None
    total = sum(b["operations"] for b in ks.values())
    return 100.0 * total / ctx.trace.window_s / ops.PEAK_F32_FLOPS


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
