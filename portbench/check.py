"""The comparison that decides ``correct``: what the timed jobs produced,
judged by the plain reference (``reference/ssm.py``) in float64.

As each job of the window ends, a sample of the jump-chain heads that it
corrected is drawn from the run's seed and kept with the moments of its
draws (``keep``); the rest of its output goes.  Once the window has
closed, the kept heads are spread evenly over the jobs, and the reference
works out again, at each sampled head's theta, what the program derived
there:

``approx_post_gap``  the largest |log prior + approximate
    log-likelihood| gap at the heads, nats: the Laplace approximation of
    the chain, which the program's set-up and timed path derived from the
    same series;
``is_mean_gap``      |mean over the heads of exp(d) - 1|, d the program's
    log-weight less the reference's psi-APF estimate with many particles:
    the correction is an unbiased estimate of the likelihood ratio, so the
    mean of exp(d) is 1 up to Monte-Carlo error;
``is_noise_gap``     |sd(d) / sd(d_ref) - 1|, d_ref the same difference for
    the reference's own psi-APF with the program's particles and resampling
    period: the program's estimator has the spread of the one it claims to
    be (a correction that skips heads, particles or steps does not);
``chain_moment_gap`` the largest, over the jobs and the parameters,
    of |chain mean - posterior mean| / posterior sd and |chain sd /
    posterior sd - 1|, the posterior being the approximate one (the chain's
    target), integrated by the reference on a grid around the draws;
``plain_routes``     the wrappers the port ran as plain PyTorch in place of
    a kernel, which no cell may take.

``evaluate(..., control=True)`` gives also the numbers of the control, the
reference itself put in the program's place in bfloat16, the precision
below the configurations' float32 (``python3 -m portbench.readings``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference import ssm

CONTROL_DTYPE = torch.bfloat16
# the program's Laplace tolerance in float32 (50 eps), for the pass counts
FLOAT32_TOL = 50.0 * float(torch.finfo(torch.float32).eps)
# passes the bfloat16 control may take: it never converges
CONTROL_MAX_ITER = 20
# a grid row whose Laplace iteration still moves by more than this (far out
# in the tails; a few cycle for ever) is left out of the grid's moments
GRID_TOL = 1e-8


class Heads(NamedTuple):
    theta: np.ndarray       # (K, d) sampled space
    prior: np.ndarray       # (K,)
    approx_ll: np.ndarray   # (K,)
    log_w: np.ndarray       # (K,) corrected less approximate posterior


def keep(job, k: int, seed: int, j: int):
    """``job`` holding only what the check reads of it, so that the window
    does not keep every job's arrays: up to ``k`` of its jump-chain heads
    (slot 0 of a chain or an accepted slot), drawn without replacement from
    the run's seed in random order, and the mean and sd of its stored
    draws."""
    a = job.arrays
    C, S = a["accepted"].shape
    head = a["accepted"].copy()
    head[:, 0] = True
    idx = np.flatnonzero(head.reshape(-1))
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17, j]))
    pick = rng.choice(idx, size=min(k, idx.size), replace=False)
    th = a["theta_sampled"].reshape(C * S, -1)
    prior = a["prior"].reshape(-1)[pick].astype(np.float64)
    all_ = a["approx_ll"].reshape(-1)[pick].astype(np.float64)
    post = a["posterior"].reshape(-1)[pick].astype(np.float64)
    heads = Heads(th[pick].astype(np.float64), prior, all_,
                  post - prior - all_)
    return job._replace(arrays={"heads": heads, "moments": _moments_of(th)})


def _moments_of(x: np.ndarray, block: int = 1 << 20):
    """Mean and sd (float64) of each column of ``x``, in blocks of rows."""
    shift = x[0].astype(np.float64)
    s1 = np.zeros_like(shift)
    s2 = np.zeros_like(shift)
    for b in range(0, x.shape[0], block):
        xb = x[b:b + block].astype(np.float64) - shift
        s1 += xb.sum(0)
        s2 += np.square(xb).sum(0)
    m = s1 / x.shape[0]
    return shift + m, np.sqrt(np.maximum(s2 / x.shape[0] - m * m, 0.0))


def sample_heads(jobs, k: int) -> Heads:
    """``k`` of the jobs' kept heads, as evenly over the jobs as ``k``
    allows."""
    per = [k // len(jobs) + (j < k % len(jobs)) for j in range(len(jobs))]
    parts = [Heads(*(x[:kj] for x in job.arrays["heads"]))
             for job, kj in zip(jobs, per)]
    return Heads(*(np.concatenate(x) for x in zip(*parts)))


def _grid(center, sd, points: int, device):
    """A product grid of ``points`` per axis over center +- 6 sd."""
    axes = [torch.linspace(c - 6 * s, c + 6 * s, points, dtype=torch.float64,
                           device=device) for c, s in zip(center, sd)]
    return torch.stack([g.reshape(-1) for g in
                        torch.meshgrid(*axes, indexing="ij")], -1)


def _moments(theta: torch.Tensor, logt: torch.Tensor):
    """Mean and sd of each axis of a grid weighed by exp(logt)."""
    w = torch.exp(logt - logt[torch.isfinite(logt)].max())
    w = torch.where(torch.isfinite(w), w, torch.zeros_like(w))
    w = w / w.sum()
    mean = (w[:, None] * theta).sum(0)
    sd = torch.sqrt((w[:, None] * torch.square(theta - mean)).sum(0))
    return mean, sd


def _chain_gap(jobs, mean_g: np.ndarray, sd_g: np.ndarray):
    """The largest gap over the jobs, and each job's (mean, sd) of the
    draws."""
    worst, each = 0.0, []
    for job in jobs:
        mc, sc = job.arrays["moments"]
        each.append((mc.tolist(), sc.tolist()))
        gap = max(np.max(np.abs(mc - mean_g) / sd_g),
                  np.max(np.abs(sc / sd_g - 1.0)))
        worst = max(worst, float(gap))
    return worst, each


class Evaluation(NamedTuple):
    numbers: dict           # name -> reading
    passes_mean: Optional[float]   # the reference's Laplace passes a head
    control: Optional[dict]        # name -> the control's reading
    details: dict                  # what the numbers were taken from


def evaluate(cfg: dict, cfgmod, y: np.ndarray, mix: dict, jobs: list,
             plain_routes: int, seed: int, device,
             control: bool = False) -> Evaluation:
    """The numbers of this run's jobs, each cut by ``keep`` (and with
    ``control`` the control's at the same heads)."""
    chk = mix["check"]
    ent = mix["run"]
    N, kk = int(ent["particles"]), int(ent.get("psi_resample_every", 1))
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([seed, 19]).generate_state(1)[0]))
    heads = sample_heads(jobs, int(chk["heads"]))
    K = heads.theta.shape[0]
    th = torch.as_tensor(heads.theta, dtype=torch.float64, device=device)

    rows = th
    mean_c, sd_c = jobs[0].arrays["moments"]
    if np.all(sd_c > 0):
        grid = _grid(mean_c, sd_c, int(chk["grid"]), device)
        rows = torch.cat([th, grid])
    sysm = cfgmod.system(cfg, y, rows)
    lap = ssm.laplace(sysm, count_tol=FLOAT32_TOL, must=K)
    lp = ssm.log_prior(cfg["priors"], rows)
    head_sys = cfgmod.system(cfg, y, th)
    head_lap = _rows(lap, K)

    numbers = {"plain_routes": float(plain_routes)}
    details = {"heads": K}
    ok = np.isfinite(heads.prior)
    post_p = heads.prior + heads.approx_ll
    post_r = (lp[:K] + lap.loglik[:K]).cpu().numpy()
    numbers["approx_post_gap"] = float(np.max(np.abs(post_p - post_r)[ok]))
    lw_big = ssm.psi_apf(head_sys, head_lap, int(chk["particles_ref"]), gen)
    lw_n = ssm.psi_apf(head_sys, head_lap, N, gen, kk)
    big = lw_big.cpu().numpy()
    d = (heads.log_w - big)[ok]
    d_ref = (lw_n.cpu().numpy() - big)[ok]
    numbers["is_mean_gap"] = (_mean_gap(d) if np.isfinite(d).all()
                              else math.inf)
    numbers["is_noise_gap"] = float(abs(np.std(d) / np.std(d_ref) - 1.0))
    grid_mom = None
    if rows.shape[0] > K:
        lt = torch.where(lap.diff[K:] <= GRID_TOL, lp[K:] + lap.loglik[K:],
                         torch.full_like(lp[K:], -math.inf))
        mean_g, sd_g = _moments(rows[K:], lt)
        grid_mom = (rows[K:], mean_g, sd_g)
        numbers["chain_moment_gap"], each = _chain_gap(
            jobs, mean_g.cpu().numpy(), sd_g.cpu().numpy())
        details["grid"] = {"mean": mean_g.tolist(), "sd": sd_g.tolist(),
                           "rows_left_out": int(
                               (lap.diff[K:] > GRID_TOL).sum())}
        details["chains"] = each
    else:                       # the chains never left their start
        numbers["chain_moment_gap"] = math.inf
    passes = float(head_lap.passes.double().mean())
    details["d_sd"] = float(np.std(d))
    details["d_ref_sd"] = float(np.std(d_ref))

    ctrl = None
    if control:
        ctrl = _control(cfg, cfgmod, y, heads, head_lap, big, d_ref, N, kk,
                        gen, grid_mom, ok, device)
    return Evaluation(numbers, passes, ctrl, details)


def _rows(lap: ssm.Laplace, k: int) -> ssm.Laplace:
    """The first ``k`` rows of an approximation."""
    return ssm.Laplace(*(x[:k] for x in lap[:6]),
                       ssm.Filtered(*(x[:k] for x in lap.filtered)),
                       lap.diff[:k])


def _finite_max(x: np.ndarray) -> float:
    x = x[np.isfinite(x)]
    return float(np.max(x)) if x.size else math.nan


def _mean_gap(d: np.ndarray) -> float:
    """|mean exp(d) - 1| of the finite entries (exp capped below float64's
    overflow)."""
    d = d[np.isfinite(d)]
    return float(abs(np.mean(np.exp(np.minimum(d, 700.0))) - 1.0))


def _control(cfg, cfgmod, y, heads, head_lap, big, d_ref, N, kk, gen,
             grid_mom, ok, device) -> dict:
    """The reference in the program's place, in bfloat16: the chain's
    Laplace approximation and the correction's filter on it.  Its
    readings are taken over its finite answers: a non-finite one fails
    anyway, and leaving it out gives the lowest reading it can claim."""
    lo = CONTROL_DTYPE
    th = torch.as_tensor(heads.theta, dtype=torch.float64, device=device)
    sys_lo = cfgmod.system(cfg, y, th.to(lo))
    out = {}
    lap_lo = ssm.laplace(sys_lo, conv_tol=0.0, max_iter=CONTROL_MAX_ITER)
    post_lo = (ssm.log_prior(cfg["priors"], th.to(lo))
               + lap_lo.loglik).double().cpu().numpy()
    post_r = (ssm.log_prior(cfg["priors"], th)
              + head_lap.loglik).cpu().numpy()
    out["approx_post_gap"] = _finite_max(np.abs(post_lo - post_r)[ok])
    lw = ssm.psi_apf(sys_lo, lap_lo, N, gen, kk).double().cpu().numpy()
    d = (lw - big)[ok]
    out["is_mean_gap"] = _mean_gap(d)
    out["is_noise_gap"] = float(abs(np.std(d[np.isfinite(d)])
                                    / np.std(d_ref) - 1.0))
    out["control_nonfinite_share"] = float(np.mean(~np.isfinite(d)))
    if grid_mom is not None:
        grid, mean_g, sd_g = grid_mom
        sys_g = cfgmod.system(cfg, y, grid.to(lo))
        lap_g = ssm.laplace(sys_g, conv_tol=0.0, max_iter=CONTROL_MAX_ITER)
        lt = (ssm.log_prior(cfg["priors"], grid.to(lo))
              + lap_g.loglik).double()
        m_lo, s_lo = _moments(grid, lt)
        out["chain_moment_gap"] = float(max(
            torch.max(torch.abs(m_lo - mean_g) / sd_g),
            torch.max(torch.abs(s_lo / sd_g - 1.0))))
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, the checks as name -> {value, limit}); a number passes when
    it is finite and at most its limit."""
    checks, good = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            good = False
    return good, checks
