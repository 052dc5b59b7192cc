"""The entries a traffic mix can drive: one general driver per public entry
point of the port, read from the mix's data file.

``fit``: ``run_mcmc(model, **mix["run"])`` as one job, each with its own
seed; its work is chains x iterations.

A job returns a ``Job``: its wall seconds (host clock, after a device
synchronisation), its units of work, the output's phase times and rows
corrected, and the arrays the check reads, already on the host (which the
harness cuts to the check's sample as soon as the job has ended).
"""
from __future__ import annotations

import time
from typing import NamedTuple


class Job(NamedTuple):
    seed: int
    start: float            # host clock, after the previous job's end
    wall: float             # seconds
    work: float             # units of the cell's rate
    time: dict              # the output's phase seconds
    n_corrected: int
    iters: int
    arrays: dict            # see ``_arrays``


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _arrays(out) -> dict:
    """What the check reads of an IS output, as references to its host
    arrays: the sampled-space thetas, the jump-chain heads, the stored
    approximate log-likelihoods and log priors and the corrected log
    posterior."""
    return dict(theta_sampled=out.theta_sampled, accepted=out.accepted,
                approx_ll=out.approx_loglik, prior=out.prior,
                posterior=out.posterior)


class Fit:
    """Jobs of ``run_mcmc`` with the mix's arguments."""

    def __init__(self, bt, torch, model, mix: dict, device, seed: int):
        self.bt, self.torch, self.model = bt, torch, model
        self.run, self.device = dict(mix["run"]), device
        self.warmup_iter = int(mix.get("warmup_iter", 20))
        self.rate_units = self.run["n_chains"] * self.run["iter"]

    def warm_up(self, seed: int) -> None:
        """One short fit at the cell's widths: the kernels are built and
        loaded, and every shape of a chain iteration and of a correction
        chunk is made once."""
        kw = dict(self.run, iter=self.warmup_iter)
        self.bt.run_mcmc(self.model, seed=seed, device=self.device, **kw)
        _sync(self.torch, self.device)

    def job(self, seed: int) -> Job:
        t0 = time.time()
        out = self.bt.run_mcmc(self.model, seed=seed, device=self.device,
                               **self.run)
        _sync(self.torch, self.device)
        wall = time.time() - t0
        return Job(seed, t0, wall, float(self.rate_units), dict(out.time),
                   int(out.n_corrected or 0), int(self.run["iter"]),
                   _arrays(out))


ENTRIES = {"fit": Fit}


def make(bt, torch, model, mix: dict, device, seed: int):
    """The driver of ``mix["entry"]``."""
    return ENTRIES[mix["entry"]](bt, torch, model, mix, device, seed)
