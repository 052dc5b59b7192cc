"""PyTorch port vs the JAX package: the global Gaussian approximation
(``run_mcmc(local_approx=False)``), on the CPU.

The pseudo-observations are solved once, at the model's initial theta; each
evaluation is one smoother pass of the approximating model they define.
Held against the JAX package's ``_family_ops(..., local_approx=False)
.approx_eval`` row by row, and end to end (approx and is2 runs) within
Monte-Carlo error.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bssm_tpu.core.priors import halfnormal_prior as j_halfnormal
from bssm_tpu.core.priors import uniform_prior as j_uniform
from bssm_tpu.inference import mcmc as jmcmc
from bssm_tpu.models.bsm import bsm_ng as jbsm_ng
from bssm_tpu.models.svm import svm as jsvm

import bssm_tpu_torch as bt
from bssm_tpu_torch.diagnostics.summary import weighted_mean
from bssm_tpu_torch.inference import mcmc as tmcmc
from bssm_tpu_torch.ops import cuda_kalman as ck


def _pair(family, n=30, seed=0):
    rng = np.random.default_rng(seed)
    if family == "svm":
        h = np.zeros(n)
        for t in range(1, n):
            h[t] = 0.9 * h[t - 1] + 0.3 * rng.normal()
        y = 0.8 * np.exp(h / 2) * rng.normal(size=n)
        jm = jsvm(y, rho=j_uniform(0.9, -0.999, 0.999),
                  sd_ar=j_halfnormal(0.3, 1.0), sigma=j_halfnormal(0.8, 2.0),
                  dtype=jnp.float64)
        tm = bt.svm(y, rho=bt.uniform_prior(0.9, -0.999, 0.999),
                    sd_ar=bt.halfnormal_prior(0.3, 1.0),
                    sigma=bt.halfnormal_prior(0.8, 2.0), dtype=torch.float64,
                    device="cpu")
        return jm, tm
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    y = y.astype(float)
    y[n // 3] = np.nan
    kw = dict(a1=np.array([1.0, 0.0]), P1=np.diag([1.0, 0.01]),
              distribution="poisson")
    jm = jbsm_ng(y, sd_level=j_halfnormal(0.1, 1.0),
                 sd_slope=j_halfnormal(0.01, 0.1), dtype=jnp.float64, **kw)
    tm = bt.bsm_ng(y, sd_level=bt.halfnormal_prior(0.1, 1.0),
                   sd_slope=bt.halfnormal_prior(0.01, 0.1),
                   dtype=torch.float64, device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("family", ["poisson", "svm"])
def test_global_evaluation_matches_jax_row_by_row(family):
    """Six thetas around the initial value, one of them with state
    standard deviations of 1e-7 (R R' summed near the degenerate-model
    threshold, where the kernel's rule and the plain log-likelihood's could
    part; with Htilde > 0 neither fires): the port's evaluation of the
    batch against the JAX package's ``approx_eval`` per theta, loglik and
    mode within 1e-9."""
    jm, tm = _pair(family)
    rng = np.random.default_rng(1)
    d = jm.theta_init.shape[0]
    thetas = np.asarray(jm.theta_init) + 0.3 * rng.normal(size=(6, d))
    if family == "poisson":
        thetas[5] = np.log([1e-7, 1e-7])
    else:
        thetas[5, 1] = np.log(1e-7)
    ops = jmcmc._family_ops(jm, 1e-8, 100, local_approx=False)
    jll, jmode = jax.jit(jax.vmap(
        lambda t: ops.approx_eval(jm.build(t), None)))(jnp.asarray(thetas))
    approx = tmcmc._approx_evaluator(tm, 1e-8, 100, local_approx=False)
    ll, mode = approx.evaluate(tm.build(torch.as_tensor(thetas)))
    assert np.isfinite(np.asarray(jll)).all()
    jll = np.asarray(jll)
    assert (np.abs(ll.numpy() - jll) <= 1e-9 * (1 + np.abs(jll))).all(), (
        ll.numpy() - jll)
    np.testing.assert_allclose(mode.numpy(), np.asarray(jmode), rtol=0,
                               atol=1e-9)
    assert ck.LAUNCHES["laplace_solve"] == 0     # nothing launches on the CPU


def _stats(out, weighted=True):
    """Pooled (weighted) means and standard errors from the spread of the
    per-chain means."""
    C, _, d = out.theta.shape
    w = out.weights if weighted and out.weights is not None else np.ones(
        out.theta.shape[:2])
    means = np.array([[weighted_mean(out.theta[c, :, j], w[c])
                       for j in range(d)] for c in range(C)])
    pooled = np.array([weighted_mean(out.flat_theta()[:, j], w.reshape(-1))
                       for j in range(d)])
    return pooled, means.std(axis=0, ddof=1) / np.sqrt(C)


def test_global_runs_match_within_monte_carlo_error():
    """run_mcmc(mcmc_type="is2", local_approx=False), 12 chains x 300
    iterations, psi with 10 particles, on both sides: the unweighted means
    (the approximate chain, what ``mcmc_type="approx"`` returns) within 4
    combined Monte-Carlo standard errors of the JAX package's, acceptance
    within 0.08.  The weighted means, the posterior, within 4 of the JAX
    package's local is2 run's: the port's weights are the ratio of the
    likelihood estimate to the stored global approximate likelihood, where
    the JAX package's are relative to the approximation rebuilt at the
    mode, another likelihood than phase 1's.  The port
    records the approximation and keeps the modes even when asked not to;
    its approx run is the is2 run's chain."""
    jm, tm = _pair("poisson", n=24, seed=3)
    kw = dict(iter=300, particles=10, output_type="theta", n_chains=12,
              seed=4, mcmc_type="is2")
    jglob = jmcmc.run_mcmc(jm, local_approx=False, **kw)
    jloc = jmcmc.run_mcmc(jm, **kw)
    tout = bt.run_mcmc(tm, device="cpu", store_modes=False,
                       local_approx=False, **kw)
    assert tout.theta.shape == jglob.theta.shape == (12, 150, 2)
    assert tout.local_approx is False and tout.modes.shape == (12, 150, 24)
    assert np.isfinite(tout.weights).all()
    for ref, weighted in ((jglob, False), (jloc, True)):
        jmean, jse = _stats(ref, weighted)
        tmean, tse = _stats(tout, weighted)
        z = np.abs(jmean - tmean) / np.sqrt(jse ** 2 + tse ** 2)
        assert (z < 4.0).all(), (weighted, jmean, tmean, jse, tse)
    assert abs(jglob.acceptance_rate - tout.acceptance_rate) < 0.08
    ap = bt.run_mcmc(tm, device="cpu", local_approx=False,
                     **{**kw, "mcmc_type": "approx"})
    assert np.array_equal(ap.theta, tout.theta) and ap.weights is None


def test_global_estimate_targets_the_likelihood():
    """At one theta well away from the initial value, 2048 rows of
    ``_pf_loglik`` (psi, N = 32) on the global approximation: the log of
    the rows' mean likelihood estimate agrees with the local
    approximation's within 4 combined standard errors (delta method over
    the rows).  The JAX package's global estimate (the global approximate
    log-likelihood plus the log-weight against the approximation rebuilt
    at the mode) misses it by more than 4."""
    from bssm_tpu_torch.inference import approx as tapprox
    from bssm_tpu_torch.inference import particle as tpf
    _, tm = _pair("poisson", n=24, seed=6)
    th = torch.as_tensor(np.asarray(tm.theta_init) + np.array([0.0, 3.0]))
    th = th.expand(2048, -1)
    glob = tmcmc._approx_evaluator(tm, 1e-8, 100, local_approx=False)
    rows = [tmcmc._pf_loglik(tm, th, torch.Generator().manual_seed(1), 32,
                             "psi", approx)[0]
            for approx in (tmcmc._approx_evaluator(tm, 1e-8, 100), glob)]
    spec = tm.build(th)
    ll, mode = glob.evaluate(spec)
    al = tmcmc._psi_al(spec, tapprox.approximate_for_is(spec, mode))
    rows.append(ll + tpf.psi_logw(spec, al, 32,
                                  torch.Generator().manual_seed(1)))
    est = []
    for r in rows:
        w = torch.exp(r - r.max()).numpy()
        est.append((float(r.max()) + np.log(w.mean()),
                    w.std(ddof=1) / np.sqrt(w.size) / w.mean()))
    (a, sa), (b, sb), (c, sc) = est
    assert abs(a - b) < 4 * np.hypot(sa, sb), est
    assert abs(a - c) > 4 * np.hypot(sa, sc), est


def test_post_correct_refuses_a_global_run_without_modes():
    """A global run replays through ``post_correct`` from its stored modes;
    without them it is refused, as any run that is not local."""
    _, tm = _pair("poisson", n=16, seed=5)
    ap = bt.run_mcmc(tm, iter=20, mcmc_type="approx", local_approx=False,
                     n_chains=2, device="cpu")
    pc = bt.post_correct(tm, ap, 8, output_type="theta")
    assert np.isfinite(pc.weights).all() and pc.local_approx is False
    ap.modes = None
    with pytest.raises(ValueError, match="local approximation"):
        bt.post_correct(tm, ap, 8)
