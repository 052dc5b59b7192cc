"""Post-hoc IS correction of an approximate run, and particle-count tuning.

Counterpart of ``bssm_tpu/inference/postcorrect.py``.  ``post_correct``
re-weights a stored approximate-MCMC run with psi-APF or bootstrap-filter
corrections through ``run_mcmc``'s own ``_is_postprocess``, so is2 corrects
jump-chain heads only, and ``post_correct(generator=
is_correction_generator(seed, device))`` replays a ``run_mcmc(mcmc_type=
"is*")`` correction with the same ``seed`` and ``corr_batch``.

``suggest_N`` picks the smallest particle count whose psi-APF log-weight
standard deviation at a reference theta (e.g. the MAP) is below 1: the
approximation of the one model at theta (the single-model Laplace solve),
then ``replications`` corrections per candidate in one batched call.
"""
from __future__ import annotations

import copy
import time as _time
from typing import Optional

import numpy as np
import torch

from ..diagnostics import profiling
from ..models.base import Model
from .mcmc import (Approximation, McmcOutput, _is_postprocess,
                   _make_correct_rows, _store_correction,
                   is_correction_generator)
from . import approx as approx_mod
from .approx_mv import approximate_mv
from .nlg import approximate_nlg
from .filters import spec_of, theta_of

__all__ = ["post_correct", "suggest_N", "is_correction_generator"]


def post_correct(model: Model, output: McmcOutput, particles: int,
                 sampling_method: str = "psi", is_type: int = 2,
                 seed: int = 1, mesh=None, corr_batch: int = 256,
                 output_type: str = "full",
                 generator: Optional[torch.Generator] = None) -> McmcOutput:
    """IS-correct a stored approximate run; returns a new output with
    weights, posterior and, for ``output_type`` "full" / "summary", the
    states.  The arguments bind in the JAX package's order, ``generator``
    in ``key``'s place; it defaults to one seeded from ``seed`` on the
    model's device.  The correction uses the defaults of ``run_mcmc``
    (``conv_tol``, ``max_iter``, ``psi_resample_every``).

    A run stored without its modes is corrected by recomputing the
    approximation cold at each row, which reproduces phase 1's (it cold
    starts too); that holds only for a run on the local approximation, so
    any other run without modes is refused.  A run on the global
    approximation (``local_approx`` False) is weighed against its stored
    approximate likelihood (``Approximation.estimates_loglik``).

    ``mesh`` (``parallel.make_mesh``): every rank calls ``post_correct`` on
    the whole stored run; the rows of the correction are split over the
    mesh as in ``run_mcmc``'s, each drawn as without a mesh, and every rank
    returns the whole output."""
    if output.theta_sampled is None or output.approx_loglik is None:
        raise ValueError("post_correct needs an approximate or IS run of "
                         "the port (theta_sampled and approx_loglik)")
    if output.modes is None and output.local_approx is not True:
        raise ValueError("this run stored no modes and did not use the "
                         "local approximation: its approximation cannot be "
                         "recomputed")
    if output_type not in ("theta", "summary", "full"):
        raise NotImplementedError(f"output_type={output_type!r}")
    t0 = _time.time()
    dev, dt = model.device, model.dtype

    def on_dev(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    with profiling.fit("post_correct", seed, "bssm.post_correct"):
        with profiling.span("bssm.post_correct.to_device"):
            if output.modes is None:
                modes = None
            elif model.kind == "sde":       # the stored evaluation seeds
                modes = torch.as_tensor(np.asarray(output.modes),
                                        dtype=torch.int64, device=dev)
            else:
                modes = on_dev(output.modes)
            approx_ll = on_dev(output.approx_loglik)
            thetas = on_dev(output.theta_sampled)
            accepted = torch.as_tensor(np.asarray(output.accepted),
                                       dtype=torch.bool, device=dev)
            base_lp = on_dev(output.prior) + approx_ll
        mesh_run = None
        if mesh is not None:
            from ..parallel.mesh import MeshRun
            mesh_run = MeshRun(mesh, torch.device(dev))
        with profiling.span("bssm.correct"):
            post, n_rows = _is_postprocess(
                model, thetas, modes, accepted, approx_ll, generator,
                nsim=particles, sampling_method=sampling_method,
                batch_size=int(corr_batch), is_type=int(is_type),
                want_states=output_type == "full",
                want_moments=output_type == "summary",
                approx=Approximation(is_global=output.local_approx is False),
                mesh_run=mesh_run)
            out = copy.copy(output)
            out.alpha = out.alphahat = out.Vt = None
            _store_correction(out, post, base_lp,
                              lambda x: x.detach().cpu().numpy())
    out.mcmc_type = f"is{int(is_type)}"
    out.output_type = output_type
    out.n_corrected = n_rows
    out.time = dict(output.time or {}, correction=_time.time() - t0)
    return out


def suggest_N(model: Model, theta=None,
              candidates=tuple(range(10, 101, 10)),
              replications: int = 100, seed: int = 1,
              sampling_method: str = "psi") -> dict:
    """Smallest N of ``candidates`` whose log-weight standard deviation over
    ``replications`` corrections at ``theta`` (default: the initial value)
    is below 1; ``{"N": ..., "sd": ..., "all": {N: sd}}``.  Candidate N
    draws its randomness from a generator seeded with ``seed + N``.  An
    SDE model raises ``ValueError`` (the JAX package's ``suggest_N`` fails
    on one with either method)."""
    if model.kind == "sde":
        raise ValueError("suggest_N does not take an SDE model")
    th = theta_of(model, theta)
    solve = {"mng": approximate_mv,
             "nlg": approximate_nlg}.get(model.kind, approx_mod.approximate)
    mode = solve(spec_of(model, th)).mode    # (1, n), (1, n, p) or (1, n, m)
    rows = th.expand(replications, -1)
    modes = mode.expand((replications,) + mode.shape[1:]).contiguous()
    results = {}
    for N in candidates:
        correct_rows = _make_correct_rows(model, int(N), sampling_method)
        gen = torch.Generator(device=model.device).manual_seed(
            int(seed) + int(N))
        lw = correct_rows(rows, modes, gen)["log_w"]
        results[N] = float(lw.double().std(unbiased=False))
        if results[N] < 1.0:
            return {"N": N, "sd": results[N], "all": results}
    last = max(candidates)
    return {"N": last, "sd": results[last], "all": results}
